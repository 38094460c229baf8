"""Build and load the port's CUDA kernels.

The sources under ``kernels/csrc/`` are compiled at first use, one
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c`` per source, all
started together, and linked with ``nvcc -shared`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The library
lands in ``kernels/.build/<hash>/``, keyed on a hash of the sources and
the flags, so a changed source rebuilds and an unchanged one loads at
once.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.core import tables as T
from repro_torch.kernels import runtime

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / ".build"
LIB_NAME = "libreprotorch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

class BuildError(RuntimeError):
    """The kernel library could not be built (no ``nvcc``, or ``nvcc``
    failed): no launch can succeed in this process."""


class CudaError(RuntimeError):
    """A C entry point returned a CUDA error code.  The error may be
    sticky: the context is then unusable."""


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "transcode_set_tables": [_P, _P, _P],
    "transcode_count": [_I, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "transcode_write": [_I, _I, _P, _I, _I, _I, _I, _P, _I, _P, _P],
    "transcode_onepass": [_I, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                          _P, _P],
    "transcode_rcount": [_I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P,
                         _P],
    "transcode_rwrite": [_I, _I, _P, _I, _I, _P, _P, _P, _I, _P, _I, _P, _P],
    "transcode_ronepass": [_I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P,
                           _P, _P, _P, _P, _P, _P],
    "legacy_validate": [_I, _P, _I, _I, _P, _P],
    "legacy_decode": [_I, _P, _I, _I, _I, _P, _P, _P],
    "legacy_encode": [_I, _P, _I, _I, _I, _P, _P, _P],
    "windowed_utf8": [_I, _P, _I, _I, _P, _I, _P, _P, _P, _P],
    "windowed_utf16": [_I, _P, _I, _I, _P, _I, _P, _P, _P],
    "flash_attention_fwd": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _F, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise BuildError(
        "nvcc not found: the CUDA kernels are built at first use and need "
        "the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet;
    return the library's path.  Each source compiles in its own ``nvcc``
    process, all at once; the compilers' reports (registers, shared
    memory, spills) are kept beside the library as ``nvcc.log``."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out_dir))
    nvcc = _nvcc()
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(work / f"{src.stem}.o"),
               str(src)]
        jobs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, proc in jobs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err[-4000:]}")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(work / LIB_NAME),
               *(str(work / f"{Path(c[-1]).stem}.o") for c, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
    (out_dir / "nvcc.log").write_text("\n".join(log))
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise BuildError("nvcc failed: " + "\n".join(failed))
    os.replace(work / LIB_NAME, lib)
    shutil.rmtree(work, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _tables_on(device_index: int) -> None:
    """Load the Keiser-Lemire tables into the device's constant memory
    (once per device)."""
    tables = [T.BYTE_1_HIGH, T.BYTE_1_LOW, T.BYTE_2_HIGH]
    with torch.cuda.device(device_index):
        rc = load().transcode_set_tables(
            *[t.ctypes.data_as(ctypes.c_void_p) for t in tables])
    check(rc, "transcode_set_tables")


def library(device: torch.device) -> ctypes.CDLL:
    """The loaded library, with its tables ready on ``device``."""
    _tables_on(device.index if device.index is not None
               else torch.cuda.current_device())
    return load()


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise CudaError(f"{what}: CUDA error {rc}")


def stream_of(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def check_length(x: torch.Tensor, n: int, what: str) -> None:
    """Reject a logical length outside the buffer, and buffers past the
    kernels' int32 lane indices."""
    try:
        runtime.check_size(x.shape[0])
        runtime.resolve_n(x.shape[0], n)
    except ValueError as exc:
        raise ValueError(f"{what}: {exc}") from None


def check_tensor(t: torch.Tensor, dtype, what: str) -> None:
    """Reject what the kernels do not take: another device type or dtype,
    a non-contiguous or non-1-D tensor."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected dtype {dtype}, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(
            f"{what}: expected a contiguous 1-D tensor, got shape "
            f"{tuple(t.shape)} with strides {t.stride()}")
