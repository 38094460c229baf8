#!/usr/bin/env python3
"""Smoke run of repro_torch on one NVIDIA GPU: build, correctness, launch
counts, timing.

    python3 chip_smoke.py [--seed 0] [--out chiprun_out/chip_smoke.json]

Phases, in order; any failure exits non-zero before the last line:

  1. Device and build: print the card's name and power limit, build the
     CUDA kernels from ``src/repro_torch/kernels/csrc``.
  2. Correctness on the card.  Single buffer: every one of the 12 format
     cells × {strict, replace} × validate {True, False}, through
     ``transcode`` (onepass and fused) and ``scan``, on ~1 MiB of lipsum
     text (paper Table 4a profiles), the same text with invalid units at
     and across 1024-element tile boundaries, ``n_valid < len``, an empty
     input, a UTF-16 high-surrogate flood and UTF-32 0xFFFFFFFF / 0xD800.
     Packed batches, same cells and policies: zero-length documents, a
     document cut mid-character before one that starts with continuation
     units (or a low surrogate), invalid units at document starts and
     ends, garbage in the slack and past ``offsets[-1]``, and the same
     documents at a fixed tile span with ``pad_to_docs`` padding, through
     ``ragged_transcode`` (onepass and fused) and ``ragged_scan``.  The
     count, write and one-pass kernels on tiles of each class of their
     dispatch (ASCII, <=2-byte, general), with a class-breaking unit only
     in a tile's inflow, on views 1-15 bytes past a 16-byte boundary, and
     the ragged count, write and one-pass kernels on packed documents of
     each class; the write passes' plain versions there equal the general
     lane body alone (``stages.write_stage``, no class decision), and the
     one-pass plain versions' buffers the write passes'.  Each
     kernel is held bit-identical to its plain PyTorch version on the
     same inputs, onepass to fused, single-buffer outputs to CPython's
     codecs where they decode the input, and every document's slice of a
     ragged result to the single-buffer ``transcode`` of it alone.  The
     legacy kernel surface (``kernels/ops.py``: ``validate_utf8``,
     ``decode_utf8``, ``utf8_to_utf16``, ``utf16_to_utf8``) on the lipsum
     text and on invalid bytes across tile boundaries, a 4-byte character
     and a surrogate pair split across a tile boundary, leads truncated at
     ``n`` (tile-aligned and not), ``n_valid < len``, an empty input and a
     lone high surrogate at ``n - 1``: its validate, decode and encode
     kernels bit-identical to their plain versions (narrow and int32
     input), its outputs and flags equal to CPython's codecs.  The
     validate kernel on ``tools/inputs.py``'s tiles of each class
     of its dispatch (ASCII, <=2-byte, general: class breakers in the
     inflow only, ``n`` cut mid-tile and mid-character, int32 outside
     [0, 256)), on views 1-15 bytes past a 16-byte boundary and on all
     65,536 byte pairs, bit-identical to ``validate_plain`` and to
     ``validate_classes``.  ``transcode(strategy="blockparallel")`` and
     its ``scan`` on every single-buffer input, cell, policy and
     validate flag: an int32 buffer equal to fused's, zeros past the
     count, the same count and status.  Flash
     attention at (B, S, H, D) in {(2, 256, 4, 128), (1, 384, 2, 80),
     (2, 128, 2, 64)} x window {None, 128} x {f32, bf16}, Sq = 128 with
     Sk = 256, and edge cases at bk = 32 (a window whose first key tile
     starts inside the bf16 kernel's 64-key chunk), Sq > Sk under a
     window (rows with no live key), D = 80 and D = 32: kernel vs plain
     (f32 atol 2e-5 / rtol 1e-4, the reference tests'; bf16 atol 1e-4 /
     rtol 1e-2, one bf16 rounding step; TF32 off), and causality.  The
     windowed walks' kernels (UTF-8 -> UTF-16 and UTF-16 -> UTF-8; a
     producer, a walker and an emitter warp over a shared-memory input
     ring) bit-identical to their plain versions on ``tools/inputs.py``'s
     ``windowed_buffers`` (text of every profile, injected errors, lone
     high surrogates whose count passes the capacity, int32 values
     outside the byte and unit ranges, ``n_valid`` at 0, below one window
     and mid-character; and the ring's cases, for the wire type and
     int32: text of three ring lengths and an odd tail, invalid units,
     a 4-byte character, 12-byte windows, an ASCII block and a surrogate
     pair across stage boundaries, ``n_valid`` mid-stage, a view ``x[1:]``
     whose data is not 16-byte aligned, and the count past the capacity
     at ring size), validate on and off; and
     windowed ``transcode`` equal to fused (``buffer[:count]``, count,
     status) on text of every profile.  The fault harness on the card: an
     error injected at the one-pass wrapper's second call (the third call
     clean and equal to the first), and a truncated stream chunk (the
     stream equal to a clean stream of what was kept).
  3. The main paths, each with every kernel's launch count set to 0 just
     before and read just after: a 64 MiB UTF-8 buffer (arabic profile)
     through ``transcode`` (onepass, the default), ``transcode
     (strategy="fused")`` and ``scan`` to UTF-16; a ragged batch of 8,192
     UTF-8 documents (~71 MiB packed) through ``ragged_transcode``
     (onepass and fused) and ``ragged_scan``; the 64 MiB buffer through
     ``transcode_stream`` in chunks of seeded random sizes, split
     mid-character.  Outputs are checked against an independent encoder,
     the whole-buffer transcode and, for a sample of documents, the
     single-buffer path; blockparallel ``transcode`` and ``scan`` of
     the 64 MiB buffer equal the default ``transcode`` (no kernel
     launched).  Each kernel is held bit-identical to its plain
     version at these sizes under {strict, replace} × validate {True,
     False}, with invalid units at and across many tile boundaries; the
     one-pass kernels (their decoupled look-back) are launched 10 times
     over on each of these inputs, every launch bit-identical; the count,
     one-pass and write kernels also on the 64 MiB buffer 3 bytes past a
     16-byte boundary, and the count, write, rcount and rwrite kernels against
     the general lane body alone on the main and injected inputs.
     How many tiles of the 64 MiB buffer and of the ragged batch fall in
     each class, from the plain predicate on the host.
     The legacy ops on the 64 MiB buffer (``validate_utf8``,
     ``decode_utf8``, ``utf8_to_utf16``), then ``utf16_to_utf8`` on its
     UTF-16 transcode: equal to ``transcode`` and back to the bytes, and
     their kernels bit-identical to the plain versions there, with
     invalid units at many tile boundaries too.  ``flash_attention`` at
     the attention width of qwen3-8b (S = 4096, 32 heads of 128, causal,
     bf16 and f32) and h2o-danube-1.8b (S = 8192, 32 heads of 80, window
     4096, bf16), k/v expanded from 8 KV heads: kernel vs plain.  The
     windowed strategy on 1<<17 characters of each of the nine lipsum
     profiles, both directions, equal to fused.  ``TextPipeline`` (a byte
     LM's input: 64 documents of 8 KiB a step, ``emit="codepoints"``) for
     3 steps on the card, each batch equal to the same step on the CPU
     and its code points to CPython's decode; ``batch_transcode`` of a
     [4096, 4096] UTF-8 batch (16 MiB) to UTF-16, ``packed`` (one ronepass
     launch) equal to ``vmap`` (one onepass launch a document).
  4. Timing with CUDA events (median of one call after warm-up, host
     time in the call included: ``ms``): each kernel and its plain
     version at the main paths' shapes, the entry points there, and the
     single-buffer entry points (onepass, fused, blockparallel
     ``transcode`` and ``scan``) at 1<<17 characters of each lipsum
     profile (paper Tables 5 and 6); the timed kernel and plain outputs
     are held equal too.  The validate kernel also on 64 MiB of the
     latin, arabic and chinese profiles (all tiles ASCII, <=2-byte,
     general).  For flash attention also
     ``torch.nn.functional.scaled_dot_product_attention`` on the same
     inputs, as the library yardstick (the port never calls it); the
     f32 kernel's bound is its three TF32 products at the TF32 peak.
     Beside ``ms``, each kernel (and SDPA) also reports its device time
     per call, ``device_ms`` (:func:`device_ms`).  The windowed kernels
     and ``transcode(strategy="windowed")`` on 1<<17 characters of each
     profile and direction (ms, device ms, GB/s of input, steps, ns a
     step, the bytes bound and the step-latency bound of
     :func:`step_bound_ms`; the plain version once, on arabic);
     ``TextPipeline.next_batch`` per step, and
     ``batch_transcode`` packed and vmap.
  5. The models (:func:`model_phase`), the launch counts set to 0 just
     before the serving path and read just after: every arch of
     ``repro_torch.configs``, reduced and float32, card = CPU on the
     same weights (forward, prefill, 3 greedy decode steps; TF32 off);
     then qwen3-8b at its published config (36 layers, d_model 4096,
     vocab 151,936, bf16, 7.57 B random parameters from a seeded
     generator) answering four lipsum prompts as the reference's serve
     engine does at its boundary: one ``ragged_scan`` (rcount) launch at
     ingress, byte tokens in a 512 bucket, one prefill and 32 greedy
     decode steps in a context of 640, blockparallel ``transcode`` to
     UTF-16 at egress.  Greedy tokens equal a teacher-forced forward's
     argmax where its top-2 margin passes the bf16 tolerance, and bf16
     logits stay within it of an f32 copy at depth 2.  Prefill and
     decode times (host clock, synchronised) beside their bounds, the
     device's busy time from ``torch.profiler``, peak memory, ingress
     and egress times.
  6. The serve engine (:func:`engine_phase`), on phase 5's qwen3-8b,
     which is freed after it: ``repro_torch.Engine`` at the
     reference's defaults (8 slots, prompts to 512 bytes, 128 new
     tokens, the continuous scheduler) serving 16 requests submitted up
     front (UTF-8 lipsum prompts of 64-500 bytes over the length
     buckets, UTF-16LE, UTF-32LE and Latin-1 prompts, a 0xFF byte under
     ``strict``, a truncated sequence under ``replace``; ``max_new`` in
     {4, 8, 16, 32}, every egress encoding), its decode step a CUDA
     graph.  The drain runs under an unarmed fault harness with the
     launch counts set to 0 just before and read just after: only
     rcount, ronepass and onepass launch, as often as the harness saw
     their wrappers called.  Codes, offsets and sanitized prompts equal
     CPython's; no fallback, retry or breaker transition; a slot refills
     mid-wave; every slot's tokens equal a teacher-forced forward's
     argmax where its top-2 margin passes the bf16 tolerance; egress
     equals CPython's encoding.  Then the engine's egress on the eight
     UTF-8 prompts' bytes in each other encoding, with the counts set
     to 0 just before and read just after: one onepass launch a call,
     as the harness saw, and the wire bytes equal CPython's.  One graph
     step equals each of 5 eager steps, each from a fresh copy of the
     same state (tokens, and logits within the bf16 tolerance).  Wall
     time, requests/s, tokens/s, decode ms a step (the graph's median
     and the eager step's) beside the bytes bound, device busy time and
     launches of a replay (``torch.profiler``), prefill ms per refill,
     ingress ms per chunk, egress ms (the drain's and the echo's), time
     to first token, latency p50/p99, capture ms and peak memory.
  7. The sharded path (:func:`shard_phase`), after phase 6's drain and
     before phase 5's qwen3-8b is freed, each drive with the launch
     counts set to 0 just before and read just after: phase 3's ragged
     batch through ``ragged_transcode(strategy="sharded")`` at 1, 2, 4
     and 8 shards (slots of one card, a CUDA stream each) under strict
     and replace, and ``scan_ragged_sharded``: each bit-identical to the
     unsharded call with exactly n ronepass (or rcount) launches; 10
     more calls at 8 shards, each bit-identical; the streams of one
     8-shard call's launches from ``torch.profiler``, and whether they
     overlapped.  The 64 MiB buffer as one document among three small
     ones at 4 shards, cut inside it: bit-identical for valid text under
     both policies and for invalid units at tile starts under replace,
     under strict but past the split document's first error (the
     reference's caveat).  UTF-16, UTF-32 and Latin-1 batches of 300
     documents to UTF-8 at 4 shards, both policies, bit-identical.  The
     supervisor's 8 -> 7 -> 6 replan at full width (``shard.launch``
     failing at calls 1-4) and a hang past its watchdog then a retried
     success, both bit-identical.  ``run_sharded_waves`` over the batch
     in 4 waves of 4 shards, each gathered wave bit-identical to its
     unsharded transcode (transfer, compute and stall a wave, and the
     hidden fraction, reported), and a ``feed.stage`` fault at wave 1
     (a stage ``WaveFailure`` there, the other waves bit-identical).
     ``Engine(ingress_shards=4)`` serving phase 6's 16 requests: results,
     tokens and egress equal to phase 6's engine, rcount and ronepass
     launches 4 a chunk.  Times, each beside the card's name and power
     limit: the sharded call and scan at each shard count, whole and
     split into plan, pinning, copy in, kernels and gather, each shard's
     kernel alone, and the unsharded calls.
  8. Training (:func:`train_phase`), after phase 7 frees qwen3-8b:
     bytelm-100m reduced, float32, TF32 off, 3 steps card = CPU within
     the CPU tests' tolerance (loss, grad norm, learning rate, every
     parameter); bytelm-100m at its published config (12 layers,
     d_model 768, bf16) one step at 2 x 128 card against CPU, the
     products' backward through their ``autograd.Function``; the
     launcher (``launch.train.main``) at full width, 8 x 512: run A of
     20 steps with a checkpoint every 10, run B of 10 steps then resumed
     to 20 (the step-10 state restores bit-equal, B's batches after the
     resume equal A's, B's parameters within ``TRAIN_RESUME_REL`` of
     A's, A's loss falls), a subprocess stopped by SIGTERM after its
     first log line (exit 0, a checkpoint); one step with remat off,
     "full" and "dots" (loss equal, gradient norm within one bf16
     step); h2o-danube-1.8b at full width (24 layers, d_model 2560,
     vocab 32,000), 1 x 4096, remat "full", 3 steps on one batch (finite,
     the loss not rising); and ``launch.serve --ckpt-dir`` on run A's
     checkpoint (step 20 loaded, every response ok), its rcount, ronepass
     and onepass launches counted.  Times: a step split into
     ``next_batch``, forward, backward and optimizer, tokens/s, device
     busy ms and launches (``torch.profiler``), peak memory, checkpoint
     save and restore ms and bytes, remat's and danube's steps.
  9. The analysis stack (:func:`analysis_phase`): the steps phases 5, 6
     and 8 timed, costed on the meta device by ``launch/dryrun`` (FLOPs
     by class, bytes, the roofline's least time against the measured
     time, predicted against measured peak memory), their products
     outside attention equal to the closed forms of ``model_bounds`` and
     ``train_flops``; each transcode kernel's charge under ``CostMode``
     on phase 3's 64 MiB inputs beside the bytes behind its bound; the
     dry-run CLI on qwen3-8b ``decode_32k`` as a subprocess.
 10. Multi-rank training (:func:`multirank_phase`), after phase 9:
     bytelm-100m at its published config and the launcher's 8 x 512
     global batch, each rank a process.  (a) The launcher under
     ``torch.distributed.run`` at world 1 under NCCL, mesh (1, 1): 3
     steps bit-equal to the single-process launcher's (metrics and the
     step-3 checkpoint's files).  (b) Four gloo ranks sharing the card,
     meshes (2, 2), (4, 1) and (1, 4) (``train.sharding``: parameters
     and AdamW moments kept as the reference's specs and ZeRO-1 say,
     gathered over the data axes before use; a model axis splits the
     products, Megatron's way): loss, grad norm and step-3 parameters
     within ``MR_BF16_TOL`` of (a); each rank's resident bytes equal to
     its spec shards; each rank's pipeline launches (one ronepass a
     batch); at (2, 2) and (1, 4) the product FLOPs and the collectives'
     bytes (``CostMode``) equal to their closed forms, and the layers
     that stayed whole; the step split into gathers, forward and
     backward, model-axis and data reductions and update.  (c) The
     (2, 2) run's step-2 checkpoint resumed by two
     ranks through the launcher on ``plan_remesh``'s (1, 2) mesh and 2
     microbatches: steps 3-4 within ``MR_ELASTIC_REL`` of the four-rank
     run's.  (d) ``hierarchical_grad_sync`` at (pod 2, data 2) within
     0.02 of a plain float32 all-reduce, its int8 pod hop a quarter of
     the float32 hop's payload.  (e) h2o-danube-1.8b at full width and
     depth on two gloo ranks at (1, 2), phase 8's weights and batch, 2
     steps within ``MR_BF16_TOL`` of phase 8's: the vocab-parallel
     embedding and CE at 16,000 rows a rank.  (f) The split MoE, RG-LRU
     and Mamba in bf16 at full width, depth cut (deepseek-moe-16b at
     (2, 2), its capacity slots over the data ranks; recurrentgemma-9b
     at (1, 4), its one KV head shared by the four ranks; falcon-mamba-7b
     at (1, 2)) beside one process, ``MR_SPLIT_HELD`` steps within
     ``MR_BF16_TOL``; deepseek-moe-16b's one process run twice, equal
     as floats at both steps; deepseek-moe-16b and falcon-mamba-7b in
     float32 at the same meshes (``MR_SPLIT_F32``), both steps within
     ``MR_SEQ_F32_TOL`` of a float32 one process; the MoE layer's
     products and collectives equal to their closed form;
     recurrentgemma-9b's split serving in float32
     within ``MR_SERVE_TOL`` of one process, its k/v bytes its
     ``state_specs`` shard.  (g) The sequence split, fewer rows than
     data ranks (``MR_SEQ_TRAIN``, ``MR_SEQ_SERVE``): bytelm-100m at
     (4, 1) and falcon-mamba-7b at (2, 1) training beside one process,
     each rank's product FLOPs one process's over the data ranks and its
     collectives ``seq_closed_form``; danube, recurrentgemma-9b and
     falcon-mamba-7b serving one row at (4, 1) and (2, 2) in float32,
     a split prefill and ``MR_SEQ_DECODE`` decode steps within
     ``MR_SERVE_TOL`` of one process, each k/v and position leaf its
     ``state_specs`` shard, the recurrent states within theirs.
 11. The ``kernels`` line (all twelve kernels; ronepass's launches
     include phase 10's ranks'), then ``{"ok": true, "device": ...}``
     last.

Imports nothing of JAX or of the reference package ``repro``.  Fails when
no CUDA device is present, and when run without the rest of the repo.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
try:
    from tools import inputs    # seeded numpy text and tile-class buffers
    # the card's rates (H100 SXM data sheet): ``BF16_FLOPS``,
    # ``TF32_FLOPS``, ``F32_FLOPS`` (TF32 off), ``HBM_BW``
    from repro_torch import roofline
except ImportError:             # run without the rest of the repo
    inputs = roofline = None
# The f32 flash kernel runs three TF32 products (hi*lo, lo*hi, hi*hi) per
# product of the function, so its bound is three times the work at the
# TF32 rate.
PRODUCTS = {"bfloat16": 1, "float32": 3}
BOUND_LABEL = {"bfloat16": "operations", "float32": "operations (3xTF32)"}
SOURCE = "src/repro_torch/kernels/csrc/transcode.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
WINDOWED_SOURCE = "src/repro_torch/kernels/csrc/windowed.cu"
REPLACES = {
    "count": "src/repro/kernels/fused_transcode.py:123",
    "write": "src/repro/kernels/fused_transcode.py:137",
    "onepass": "src/repro/kernels/onepass_transcode.py:87",
    "rcount": "src/repro/kernels/ragged_transcode.py:143",
    "rwrite": "src/repro/kernels/ragged_transcode.py:161",
    "ronepass": "src/repro/kernels/ragged_transcode.py:220",
    "validate": "src/repro/kernels/utf8_validate.py:79",
    "decode": "src/repro/kernels/utf8_decode.py:58",
    "encode": "src/repro/kernels/utf16_encode.py:40",
    "flash": "src/repro/kernels/flash_attention.py:41",
    # Not Pallas kernels: the reference's lax.while_loop walks.
    "windowed_utf8": "src/repro/core/windowed.py:78",
    "windowed_utf16": "src/repro/core/windowed.py:238",
}
WINDOWED = (("utf8", "utf16"), ("utf16", "utf8"))
# The windowed walker's loop-carried chain in SM cycles a step, by step
# kind (a 64-byte ASCII block, a 12-byte window, an 8-unit register):
# the dependent instructions from the position to the ring's load and on
# to the next position, read off the SASS of windowed.cu (sm_90a, PERF.md
# has the listings), each timed by tools/step_latency.py's one-warp chases
# on the H100: an integer op 4.56 cycles (IMAD), LDS 24.56 (the LDS chase
# less its LEA), VOTE 13.01 (the ballot chase less its LOP3).  ASCII block
# (the ASCII run's loop): 5 integer ops, 1 LDS, 1 VOTE; window: 10, 2, 1;
# register: 9, 1, 1.
WALK_CHAIN_CYCLES = {64: 5 * 4.56 + 24.56 + 13.01,
                     12: 10 * 4.56 + 2 * 24.56 + 13.01,
                     8: 9 * 4.56 + 24.56 + 13.01}
# The training-input pipeline of a byte LM: 64 documents of 8 KiB of
# UTF-8 a step (512 KiB), decoded to code points on the card.
PIPE = dict(seq_len=8192, global_batch=64, emit="codepoints")
PIPE_STEPS = 3
BATCH_DOCS, BATCH_LEN = 4096, 4096     # batch_transcode: 16 MiB of UTF-8
# Flash attention at the attention width of two configurations of the
# repo (src/repro/configs/qwen3_8b.py, h2o_danube_1_8b.py): 32 query
# heads over 8 KV heads; (label, S, head_dim, window, dtype name).
FLASH_HEADS, FLASH_KV_HEADS = 32, 8
FLASH_MAIN = [("qwen3_8b causal bf16", 4096, 128, None, "bfloat16"),
              ("qwen3_8b causal f32", 4096, 128, None, "float32"),
              ("h2o_danube_1_8b window 4096 bf16", 8192, 80, 4096,
               "bfloat16")]
# (B, Sq, Sk, H, D, windows, bq, bk): the reference tests' shapes, then
# edges of the bf16 kernel's 64-key chunks: bk = 32 with the window's first
# key tile inside a chunk, Sq > Sk under a window (rows with no live key;
# Sk = 160 ends mid-chunk), D = 80 and D = 32.
FLASH_SMALL = [(2, 256, 256, 4, 128, (None, 128), 128, 128),
               (1, 384, 384, 2, 80, (None, 128), 128, 128),
               (2, 128, 128, 2, 64, (None, 128), 128, 128),
               (1, 128, 256, 2, 64, (None, 128), 128, 128),
               (1, 256, 256, 2, 64, (96,), 64, 32),
               (1, 256, 128, 1, 64, (64,), 128, 128),
               (1, 384, 128, 2, 80, (64,), 64, 32),
               (1, 256, 160, 2, 32, (64,), 64, 32),
               (1, 256, 256, 2, 32, (130,), 128, 32)]
# Launches of each one-pass kernel per main-size input and policy, every
# one bit-identical: a race in the look-back shows as a launch that
# differs.
REPEATS = 10
# Kernel vs plain on the card.  f32: the reference tests' tolerance.  bf16:
# both compute in f32 from the same bf16 inputs and differ only in the order
# of the f32 sums, so the outputs differ by at most one bf16 rounding step
# (2**-7 of the value); the reference tests' 3e-2 is for bf16 against the
# JAX reference and would pass a kernel that drops a chunk of keys.
FLASH_TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
             "bfloat16": dict(atol=1e-4, rtol=1e-2)}
BLOCK = 1024
TEXT_CHARS = 48_000            # per lipsum profile: ~1 MiB of UTF-8 in all
MAIN_BYTES = 64 << 20          # the main path's UTF-8 buffer
LIPSUM_CHARS = 1 << 17         # paper Tables 5 and 6
# The main ragged batch: the skewed mix of benchmarks/transcode_bench.py
# ::table_ragged (one long document per 8) at the size of a serving or
# data-loading wave.
RAGGED_DOCS = 8192
RAGGED_LONG, RAGGED_SHORT = 16_384, 2_048     # characters per document
STREAM_MAX_CHUNK = 4 << 20     # stream chunk sizes: log-uniform in [1, this]

# Phase 5, the models: every arch reduced (float32, card vs CPU), then
# qwen3-8b at its published config answering four requests as
# repro.serve.engine does (max_prompt 512 + max_new 128 = a context of
# 640, its batch of 4 rows).
MODEL_ARCH = "qwen3-8b"
MODEL_LANGS = ("arabic", "chinese", "emoji", "latin")
MODEL_PROMPT_BYTES = (64, 400)       # prompt sizes, uniform in this range
MODEL_BUCKET, MODEL_NEW = 512, 128
MODEL_STEPS = 32                     # greedy decode steps after the prefill
MODEL_PREFILL_REPS = 3
MODEL_DEPTH_CHECK = 2                # depth of the bf16-vs-f32 comparison
MODEL_REDUCED_CTX, MODEL_REDUCED_STEPS = 32, 3
# float32 on the card (TF32 off) against the CPU: only the order of the
# f32 sums differs.
MODEL_F32_TOL = dict(atol=1e-4, rtol=1e-4)
# bf16: two computations of the same logits (the decode path against a
# teacher-forced forward; bf16 against f32 weights) round the residual
# stream to bf16 at different places.  This script's runs of qwen3-8b on
# an H100 (700 W) measured up to 0.116 between decode and teacher-forced
# logits whose standard deviation is 1.28 (0.02 * sqrt(4096)), and a
# relative RMS error of 0.008 (max 0.068) for bf16 against f32 at depth
# 2; the tolerances give each two to four times that.  Two logits each
# off by at most d can swap only when their margin is below 2d, so
# greedy tokens are held to the teacher-forced argmax where its top-2
# margin passes BF16_LOGIT_TOL.
BF16_LOGIT_TOL = 0.25
BF16_REL_RMS = 2 ** -5
# Phase 6, the serve engine over phase 5's qwen3-8b: 16 requests (see
# engine_trace) at the reference engine's defaults; the graph-vs-eager
# step runs at this position in every row.
ENGINE_PROMPT_BYTES = (64, 500)
ENGINE_MAX_NEW = (4, 8, 16, 32)
ENGINE_ENCODINGS = ("utf-8", "utf-16-le", "utf-32-le", "latin-1")
ENGINE_CHECK_POS = 300
ENGINE_EAGER_REPS = 5                # eager decode steps timed, each fresh

# Phase 7, the sharded path: shard counts of the full-width batch, the
# 8-shard call's repeats, documents of each other cell's batch, the
# feeder's waves, the timed calls' repeats, and the hang fault against
# the watchdog (s).
SHARD_COUNTS = (1, 2, 4, 8)
SHARD_REPEATS = 10
SHARD_CELL_DOCS = 300
SHARD_WAVES = 4
SHARD_TIME_REPS = 5
SHARD_HANG_S, SHARD_WATCHDOG_S = 2.0, 1.0
# Phase 8, training: bytelm-100m at the launcher's defaults (8 x 512 a
# step), run A of 20 steps with a checkpoint every 10, run B resumed at
# 10; the timed step's warm-up and repeats; h2o-danube-1.8b at 1 x 4096.
TRAIN_ARCH = "bytelm-100m"
TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_STEPS, TRAIN_CKPT_EVERY = 20, 10
TRAIN_WARMUP, TRAIN_REPS = 2, 5
DANUBE_ARCH, DANUBE_SEQ, DANUBE_STEPS = "h2o-danube-1.8b", 4096, 3
# float32, TF32 off, card against CPU: the CPU tests' tolerance
# (tests/test_torch_train.py), the same as the port against the reference.
TRAIN_F32_TOL = dict(atol=2e-5, rtol=1e-4)
# bf16 at full width, one step, card against CPU.  Both compute every
# product exactly and sum it in float32, in different orders, and round
# activations and gradients to bf16 where the reference does; a sum that
# lands near a bf16 rounding boundary rounds the other way on the other
# device, and that difference propagates.  This script's first run on an
# H100 (700 W) measured a relative difference of 5e-6 in the loss (a
# float32 mean over 256 tokens) and 1.06e-4 in the gradient norm; the
# tolerances give them about six and five times that.  Every parameter
# after the update is held to 2 lr (the two devices' first Adam steps
# may take opposite signs where a gradient is at its rounding noise)
# plus one bf16 step (2**-7 of the value), the cast back to bf16.
TRAIN_BF16_BATCH = (2, 128)
TRAIN_BF16_TOL = {"loss_rel": 2 ** -15, "gnorm_rel": 2 ** -11,
                  "param_rel": 2 ** -7}
# Run B takes its first 10 steps under --steps 10's schedule (warm-up 5,
# cosine to step 10), run A under --steps 20's, so the two differ by
# design: their learning rates over steps 1-10 differ by 20 % of the sum
# of A's over its 20 steps.  B's final parameters are held within
# TRAIN_RESUME_REL of A's, relative to how far A's moved from the initial
# weights; a resume that restarts the weights moves B by ~the whole of it.
TRAIN_RESUME_REL = 0.5
# remat changes what is kept, not what is computed: the loss is equal;
# the gradients may be summed in another order where the backward uses
# atomics, so the gradient norm is held to one bf16 rounding step.
TRAIN_REMAT_REL = 2 ** -8
# Phase 10: four gloo ranks on one card against run (a), one rank under
# NCCL, over 3 steps of bf16 training (the reasoning below is the data
# axes'; a model axis also sums each split product's float32 partials in
# another order before its cast, the same kind of difference).  Step 1
# starts from the same
# weights, so only the order of the float32 sums differs (the CE over the
# ranks' rows, the gradient summed over the data ranks after each rank's
# bf16 cast, where (a) casts the whole batch's): the loss differs in its
# last bits, the gradient norm by about phase 8's card-vs-CPU 1.06e-4 at
# most.  Steps 2-3 start from parameters that may differ by one bf16 step
# where a value lands near a rounding boundary.  Predicted before the
# first run: loss within 2**-12 relative, grad norm within 2**-10; every
# parameter after step 3 within twice the learning rates' sum (each Adam
# step may take the other sign where a gradient is at its rounding noise)
# plus one bf16 step (2**-7 of the value) for each of the three casts.
MR_BF16_TOL = {"loss_rel": 2 ** -12, "gnorm_rel": 2 ** -10}
# The elastic resume differs by design: two microbatches, each a mean over
# its own label count (the reference's accumulate_microbatches), where the
# four-rank run takes one mean over all 8 rows; the pipeline's rows count
# 509-511 labels, so the halves' weights differ by up to ~0.4 %, and step
# 3's update with them.  The first run on an H100 (700 W) measured 4.7e-6
# at step 3 and 2.25e-4 at step 4, 0.92 of the predicted 2**-12, which left
# the weighting out; 2**-10 gives step 4 about four times its measure.
MR_ELASTIC_REL = 2 ** -10
MR_PARAM_BOUND = {"lr_sum": 2 * 3e-4 * (1 + 2 + 3) / 5, "rel": 3 * 2 ** -7}
PY_CODEC = {"utf8": "utf-8", "utf16": "utf-16-le", "utf32": "utf-32-le",
            "latin1": "latin-1"}
NP_DTYPE = {"utf8": np.uint8, "utf16": np.uint16, "utf32": np.uint32,
            "latin1": np.uint8}


def log(*parts):
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# Inputs, made with numpy from --seed.


def utf16_encode(cps: np.ndarray) -> np.ndarray:
    """Vectorised UTF-16 encoder (checked against CPython in phase 2)."""
    cps = cps.astype(np.int64)
    L = 1 + (cps >= 0x10000)
    start = np.cumsum(L) - L
    out = np.empty(int(L.sum()), np.uint16)
    v = cps - 0x10000
    out[start] = np.where(L == 1, cps, 0xD800 + (v >> 10))
    m = L == 2
    out[start[m] + 1] = 0xDC00 + (v[m] & 0x3FF)
    return out


def encode(cps: np.ndarray, fmt: str) -> np.ndarray:
    if fmt == "utf8":
        return inputs.utf8_encode(cps)
    if fmt == "utf16":
        return utf16_encode(cps)
    if fmt == "utf32":
        return cps.astype(np.uint32)
    return (cps & 0xFF).astype(np.uint8)


BAD_UNITS = {"utf8": [0xFF, 0xC0, 0x80, 0xED, 0xF4, 0xE4],
             "utf16": [0xD800, 0xDC00, 0xDBFF],
             "utf32": [0xD800, 0x110000, 0xFFFFFFFF],
             "latin1": [0x80, 0xFF]}


def inject(buf: np.ndarray, fmt: str, tiles) -> np.ndarray:
    """A copy of ``buf`` with invalid units at and across the start of
    each of ``tiles`` (a truncated pair too, in UTF-8)."""
    out = buf.copy()
    bad = BAD_UNITS[fmt]
    for k, t in enumerate(tiles):
        pos = int(t) * BLOCK - 1 + (k % 3)           # at and across
        out[pos] = bad[k % len(bad)]
        if fmt == "utf8" and k % 2:
            out[pos + 1] = 0xB8                       # truncated pair
    return out


def correctness_inputs(fmt: str, text_cps: np.ndarray, rng):
    """Named ``(buffer, n_valid)`` inputs of one source format."""
    text = encode(text_cps, fmt)
    out = [("text", text, None)]
    n_tiles = len(text) // BLOCK - 1
    tiles = rng.choice(n_tiles, size=min(64, n_tiles), replace=False) + 1
    out.append(("injected", inject(text, fmt, tiles), None))
    out.append(("n_valid<len", text, len(text) - 777))
    out.append(("empty", text[:0], None))
    if fmt == "utf16":
        out.append(("hi-surrogate-flood", np.full(len(text), 0xDBFF,
                                                  np.uint16), None))
        out.append(("surrogate-garbage", rng.integers(
            0xD800, 0xE000, len(text)).astype(np.uint16), None))
    if fmt == "utf32":
        g = text.copy()
        g[rng.integers(0, len(g), 512)] = 0xFFFFFFFF
        g[rng.integers(0, len(g), 512)] = 0xD800
        out.append(("utf32-garbage", g, None))
    return out


# Per source format: the end of a document cut mid-character, and the
# start of the next one (continuation units, a low surrogate).
CUT_TAIL = {"utf8": [0x41, 0xE4, 0xB8], "utf16": [0x41, 0xD800],
            "utf32": [0x41, 0xD800], "latin1": [0x41, 0xE9]}
CUT_HEAD = {"utf8": [0x80, 0xBF, 0x41], "utf16": [0xDC00, 0x42],
            "utf32": [0x110000, 0x42], "latin1": [0x80, 0x42]}
GEN_HI = {"utf8": 256, "utf16": 1 << 16, "utf32": 0x110000, "latin1": 256}


def ragged_inputs(fmt: str, text_cps: np.ndarray, rng):
    """Named packed batches ``(name, docs, data, offsets, lengths)`` of one
    source format: text, empty documents, a document that fills its tile
    and ends mid-character before one that starts with continuation
    units, invalid units at document starts and ends, garbage in the
    slack and past ``offsets[-1]``; then the same documents at a fixed
    tile span with padding documents."""
    from repro_torch.core import packing
    dt = NP_DTYPE[fmt]
    bad = np.asarray(BAD_UNITS[fmt], dt)
    tail, head = np.asarray(CUT_TAIL[fmt], dt), np.asarray(CUT_HEAD[fmt], dt)

    def text(n_chars):
        lo = int(rng.integers(0, len(text_cps) - n_chars))
        return encode(text_cps[lo: lo + n_chars], fmt)

    docs = [text(300), text(0),
            np.concatenate([text(BLOCK)[:BLOCK - len(tail)], tail]),
            np.concatenate([head, text(40)]), text(700),
            np.concatenate([bad[:1], text(30), bad[-1:]]), text(0),
            np.concatenate([text(1500), tail]),
            rng.integers(0, GEN_HI[fmt], 900).astype(dt)]
    out = []
    span = max(-(-len(d) // BLOCK) for d in docs)
    for name, kw in (("mixed", {}), ("fixed", dict(
            doc_tiles=span, pad_to_docs=len(docs) + 5))):
        pk = packing.pack_documents(docs, dtype=dt, **kw)
        data = np.concatenate([pk.data, rng.integers(
            0, GEN_HI[fmt], BLOCK + 77).astype(dt)])
        for d in (0, 4):
            lo = int(pk.offsets[d]) + int(pk.lengths[d])
            data[lo: int(pk.offsets[d + 1])] = bad[0]
        out.append((name, docs, data, pk.offsets, pk.lengths))
    return out


def main_ragged_docs(rng):
    """The main ragged batch: ``RAGGED_DOCS`` UTF-8 documents; document
    ``i`` of lipsum profile ``i % 9``, ``RAGGED_LONG`` characters when
    ``i % 8 == 0`` and ``RAGGED_SHORT`` otherwise, empty when
    ``i % 64 == 63``, and with one byte set to 0xFF when ``i % 32 == 7``.
    Returns ``(docs, code points of each document, {doc: 0xFF position})``."""
    langs = list(inputs.PROFILES)
    i_all = np.arange(RAGGED_DOCS)
    n_chars = np.where(i_all % 8 == 0, RAGGED_LONG, RAGGED_SHORT)
    n_chars[i_all % 64 == 63] = 0
    docs, cps_of = [None] * RAGGED_DOCS, [None] * RAGGED_DOCS
    for k, lang in enumerate(langs):
        idx = i_all[k::len(langs)]
        cps = inputs.codepoints(lang, int(n_chars[idx].sum()), rng)
        u8 = inputs.utf8_encode(cps)
        byte_at = np.concatenate([[0], np.cumsum(
            1 + (cps >= 0x80) + (cps >= 0x800) + (cps >= 0x10000))])
        c0 = 0
        for i in idx:
            c1 = c0 + int(n_chars[i])
            docs[i], cps_of[i] = u8[byte_at[c0]: byte_at[c1]], cps[c0:c1]
            c0 = c1
    injected = {}
    for i in range(7, RAGGED_DOCS, 32):
        pos = int(rng.integers(0, len(docs[i])))
        docs[i] = docs[i].copy()
        docs[i][pos] = 0xFF
        injected[i] = pos
    return docs, cps_of, injected


def legacy_inputs(text_cps: np.ndarray, rng):
    """Named ``(format, name, buffer, n_valid)`` inputs of the legacy ops:
    text, invalid units at and across tile starts, ``n_valid < len``, an
    empty input, a 4-byte character and a surrogate pair split across a
    tile boundary, leads truncated at ``n`` (tile-aligned and not) and a
    lone high surrogate at ``n - 1`` (its low half past ``n``)."""
    out = []
    for fmt in ("utf8", "utf16"):
        text = encode(text_cps, fmt)
        n_tiles = len(text) // BLOCK - 1
        tiles = rng.choice(n_tiles, size=min(64, n_tiles), replace=False) + 1
        out += [(fmt, "text", text, None),
                (fmt, "injected", inject(text, fmt, tiles), None),
                (fmt, "n_valid<len", text, len(text) - 777),
                (fmt, "empty", text[:0], None)]
    tail = text_cps[:5000]
    out.append(("utf8", "4-byte char across a tile", inputs.utf8_encode(
        np.concatenate([np.full(2 * BLOCK - 2, 0x41), [0x1F389], tail])),
        None))
    out.append(("utf16", "pair across a tile", utf16_encode(
        np.concatenate([np.full(2 * BLOCK - 1, 0x41), [0x1F389], tail])),
        None))
    for n in (4 * BLOCK, 4 * BLOCK + 321):
        b = np.full(6 * BLOCK, 0x41, np.uint8)
        b[n - 1], b[n: n + 2] = 0xE4, 0xB8
        out.append(("utf8", f"3-byte lead cut at n={n}", b, n))
        b = np.full(6 * BLOCK, 0x41, np.uint8)
        b[n - 3: n + 1] = (0xF0, 0x9F, 0x8E, 0x89)
        out.append(("utf8", f"4-byte char cut at n={n}", b, n))
    for n in (3 * BLOCK, 3 * BLOCK + 99):
        u = utf16_encode(tail).copy()
        u[n - 1], u[n] = 0xD83C, 0xDF89
        out.append(("utf16", f"lone high surrogate at n-1={n - 1}", u, n))
    return out


# A unit outside the <=2-byte tile class, and one in it but outside ASCII.
CLASS_BREAK = {"utf8": 0xE4, "utf16": 0xD800, "utf32": 0x800, "latin1": 0xFF}
IN_CLASS2 = {"utf8": 0xC3, "utf16": 0x7FF, "utf32": 0x7FF, "latin1": 0x80}


def class_inputs(fmt: str, rng):
    """Named buffers of six tiles for the count kernels' tile classes:
    all ASCII, all <=2-byte text, a mix (tiles 2-3 <=2-byte, the rest
    ASCII), then the mix with one unit outside a class in the last 1-3
    units before a tile (its inflow only) or inside it."""
    n = 6 * BLOCK
    ascii = rng.integers(0x20, 0x7F, n).astype(NP_DTYPE[fmt])
    cps = np.where(rng.random(n) < 0.7, rng.integers(0x80, 0x800, n),
                   rng.integers(0x20, 0x7F, n))
    c2 = encode(cps, fmt)[:n].copy()
    mixed = ascii.copy()
    mixed[2 * BLOCK: 4 * BLOCK] = c2[2 * BLOCK: 4 * BLOCK]
    out = [("ascii", ascii), ("class2", c2), ("mixed", mixed)]
    for tile, unit in ((1, CLASS_BREAK[fmt]), (4, CLASS_BREAK[fmt]),
                       (1, IN_CLASS2[fmt])):
        for pos in (tile * BLOCK - 3, tile * BLOCK - 2, tile * BLOCK - 1,
                    tile * BLOCK + 200):
            m = mixed.copy()
            m[pos] = unit
            out.append((f"{unit:#x} at {pos}", m))
    return out


def class_counts(stages, src: str, x, own=None) -> dict:
    """Tiles of each class of the count kernels' dispatch, from the plain
    predicate on the host: ``x`` a CPU tensor, ``own`` the packed batch's
    ownership arrays (CPU) or None for a single buffer."""
    import torch
    t, tp, _tn, _g = (stages.tiles(x, x.shape[0]) if own is None
                      else stages.ragged_tiles(x, *own[1:]))
    cls = stages.tile_class(stages.get_codec(src), t, tp)
    return {name: int((cls == c).sum()) for name, c in (
        ("ascii", stages.ASCII), ("class2", stages.CLASS2),
        ("general", stages.GENERAL))} | {"tiles": int(torch.numel(cls))}


def live_pairs(s: int, window) -> int:
    """Causal (query, key) pairs of one head, within the window if any."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_bound(s: int, d: int, window, dtype: str):
    """``(bound ms, bound_by, flops)`` of one flash call at batch 1 with
    FLASH_HEADS heads: 4 * d flops per live pair and head (the work the
    function needs, ``flops``), run as PRODUCTS[dtype] tensor-core
    products at the card's peak for the type, against q, k, v and o read
    or written once."""
    flops = 4 * d * FLASH_HEADS * live_pairs(s, window)
    nbytes = 4 * s * FLASH_HEADS * d * (2 if dtype == "bfloat16" else 4)
    peak = roofline.BF16_FLOPS if dtype == "bfloat16" \
        else roofline.TF32_FLOPS
    ops_ms = PRODUCTS[dtype] * flops / peak * 1e3
    bytes_ms = nbytes / roofline.HBM_BW * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", flops)


# ---------------------------------------------------------------------------
# Checks.


def oracle(buf: np.ndarray, n: int, src: str, dst: str, errors: str):
    """CPython's view: ``(expected units or None, first decode error in
    source elements or None)``.  Units are given under errors="replace",
    or under "strict" for an input CPython decodes cleanly."""
    raw = buf[:n].tobytes()
    size = buf.dtype.itemsize
    try:
        text, first = raw.decode(PY_CODEC[src]), None
    except UnicodeDecodeError as exc:
        text, first = raw.decode(PY_CODEC[src], "replace"), exc.start // size
    if errors == "strict" and first is not None:
        return None, first
    units = np.frombuffer(text.encode(PY_CODEC[dst], "replace"),
                          NP_DTYPE[dst])
    return units, first


def equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


class Mismatch(AssertionError):
    pass


def require(cond: bool, *ctx):
    if not cond:
        raise Mismatch(" ".join(map(str, ctx)))


def hold(name: str, kern, plain, max_err: dict, *ctx):
    """Require a kernel's outputs bit-identical to its plain version's
    (one tensor or a tuple of them) and fold the largest absolute
    difference into ``max_err[name]``."""
    if not isinstance(kern, tuple):
        kern, plain = (kern,), (plain,)
    for a, b in zip(kern, plain, strict=True):
        if a.numel() and a.shape == b.shape:
            d = (a.long() - b.long()).abs().max().item()
            max_err[name] = max(max_err[name], d)
        require(equal(a, b), f"{name} kernel vs plain", *ctx)


def hold_close(name: str, kern, plain, dtype: str, max_err: dict, *ctx):
    """Require a float kernel's output within ``FLASH_TOL`` of its plain
    version's, finite and of the same shape and type; fold the largest absolute difference into ``max_err[name]``."""
    import torch
    require(kern.shape == plain.shape and kern.dtype == plain.dtype
            and bool(torch.isfinite(kern).all()), f"{name} shape/finite",
            *ctx)
    diff = (kern.float() - plain.float()).abs()
    max_err[name] = max(max_err[name], diff.max().item())
    tol = FLASH_TOL[dtype]
    bad = diff > tol["atol"] + tol["rtol"] * plain.float().abs()
    require(not bool(bad.any()), f"{name} kernel vs plain", *ctx,
            diff.max().item())


def hold_blockparallel(bp, fused, *ctx):
    """A ``strategy="blockparallel"`` result against fused's, the
    reference's own pin: an int32 buffer of the same capacity, equal to
    fused's widened (``buffer[:count]``, and zeros past it), and the same
    count and status."""
    import torch
    require(bp.buffer.dtype == bp.count.dtype == bp.status.dtype
            == torch.int32 and bp.buffer.shape == fused.buffer.shape,
            "blockparallel dtype/shape", bp.buffer.dtype, *ctx)
    require(int(bp.count) == int(fused.count)
            and int(bp.status) == int(fused.status),
            "blockparallel count/status vs fused", int(bp.count),
            int(fused.count), int(bp.status), int(fused.status), *ctx)
    k = min(int(bp.count), bp.buffer.shape[0])
    require(not bool(bp.buffer[k:].any()), "blockparallel past count", *ctx)
    require(equal(bp.buffer.long(), fused.buffer.long()),
            "blockparallel buffer vs fused", *ctx)


def walk_steps(src: str, units: np.ndarray) -> int:
    """Steps of the windowed walk over ``units``: 64-byte ASCII blocks,
    12-byte windows and tail characters (UTF-8), or 8-unit registers, 7
    where one ends in a lone high half (UTF-16); the walk's work, for its
    time per step."""
    from tools import inputs
    return len(inputs.walk_positions(src, units))


def step_bound_ms(src: str, units: np.ndarray, clock_mhz: float) -> float:
    """The walk's step-latency bound: each ASCII block, window or
    register of the walk over ``units`` times its kind's chain
    (``WALK_CHAIN_CYCLES``) at the SM clock.  The UTF-8 tail (fewer than
    12 bytes, on one lane after the walk) is left out."""
    from tools import inputs
    rows = inputs.walk_positions(src, units)
    cycles = sum(WALK_CHAIN_CYCLES.get(int(w), 0) for w in rows[:, 1])
    return cycles / (clock_mhz * 1e3)


def hold_windowed(w, fused, *ctx):
    """A ``strategy="windowed"`` result against fused's on valid text: an
    int32 buffer of the reference's capacity (``len + 80`` or ``3 * len +
    24``), equal to fused's widened up to the count and zero past it, and
    the same count and status."""
    import torch
    require(w.buffer.dtype == w.count.dtype == w.status.dtype
            == torch.int32, "windowed dtypes", w.buffer.dtype, *ctx)
    k = int(fused.count)
    require(int(w.count) == k and int(w.status) == int(fused.status),
            "windowed count/status vs fused", int(w.count), k,
            int(w.status), int(fused.status), *ctx)
    require(equal(w.buffer[:k].long(), fused.buffer[:k].long())
            and not bool(w.buffer[k:].any()), "windowed buffer vs fused",
            *ctx)


# ---------------------------------------------------------------------------
# Timing.


def device_ms(fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds of device time per call of ``fn``: CUDA events around
    ``reps`` calls queued back to back behind a 20 ms sleep kernel, so
    that the host has issued every call before the card starts the
    first and the card never waits on the host between them.  Unlike
    :func:`cuda_ms`, it leaves out the host time of a call, which for a
    short kernel can exceed the kernel's own.  ``fn`` must not
    synchronise."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of one call of ``fn`` between two CUDA events
    (host time in the call included)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 5: the models.


def _reduced_run(model, fam, cfg, toks, lens, frames, device):
    """One reduced model on one device: the forward logits, the
    prefill's last logits and ``MODEL_REDUCED_STEPS`` greedy decode
    steps ``(tokens, logits)``, all moved to the host."""
    import torch
    from repro_torch.serve import kvcache, serve_step
    t = torch.from_numpy(toks).to(device)
    lens_t = torch.from_numpy(lens).to(device)
    with torch.no_grad():
        if fam == "encdec":
            fr = torch.from_numpy(frames).to(device)
            fwd = model(fr, t)[0]
            prefill, decode = serve_step.make_encdec_steps(model)
            last, state = prefill(model, fr, t, MODEL_REDUCED_CTX)
        else:
            fwd = (model.apply_text(t) if fam == "vlm" else model(t))[0]
            prefill = serve_step.make_prefill(model, fam)
            decode = serve_step.make_decode(model, fam)
            state = kvcache.init_state(model, cfg, len(toks),
                                       MODEL_REDUCED_CTX)
            last, state = prefill(model, t, lens_t, state)
    cur, pos, steps = last.argmax(-1).to(torch.int32), lens_t, []
    for _ in range(MODEL_REDUCED_STEPS):
        if fam == "encdec":
            cur, logits, state = decode(model, cur[:, None], state)
        else:
            cur, logits, state = decode(model, cur[:, None], pos, state,
                                        None)
            pos = pos + 1
        steps.append((cur.cpu(), logits.cpu()))
    return fwd.cpu(), last.cpu(), steps


def dense_products(cfg, tokens: int) -> dict:
    """Product FLOPs of a dense decoder's forward over ``tokens``, 2 per
    weight of a product and token: ``layers`` (the attention
    projections and the MLP of every layer) and ``unembed`` (the tied
    unembedding)."""
    d, hd = cfg.d_model, cfg.hd
    per_layer = (2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                 + 3 * d * cfg.d_ff)
    return {"layers": 2 * tokens * cfg.n_layers * per_layer,
            "unembed": 2 * tokens * cfg.vocab * d}


def model_bounds(cfg, n_params: int, batch: int, prompt: int,
                 state_bytes: int) -> dict:
    """Least times of the serving steps of a dense decoder: the prefill
    by its operations (:func:`dense_products`, the unembedding included,
    and 4 * head_dim per causal pair and head) at the bf16 peak; a
    decode step by its bytes (every weight and the decode state read
    once) at the memory rate."""
    p = dense_products(cfg, batch * prompt)
    products = p["layers"] + p["unembed"]
    attention = (4 * cfg.hd * cfg.n_heads * cfg.n_layers * batch
                 * prompt * (prompt + 1) // 2)
    decode_bytes = n_params * 2 + state_bytes
    return {"prefill_flops": products + attention,
            "prefill_bound_ms": (products + attention)
            / roofline.BF16_FLOPS * 1e3,
            "decode_bytes": decode_bytes,
            "decode_bound_ms": decode_bytes / roofline.HBM_BW * 1e3}


def device_busy(fn, top: int = 6) -> dict:
    """Device time of the kernels ``fn`` launches, from ``torch.profiler``:
    ``{"busy_ms", "launches", "top"}``, ``top`` the kernels that take
    most of it as ``[name, ms, calls]`` (``busy_ms`` None when the
    profiler reports no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), key=lambda r: -r[1])
    return {"busy_ms": sum(r[1] for r in rows) or None,
            "launches": sum(r[2] for r in rows),
            "top": [[k[:80], ms, n] for k, ms, n in rows[:top]]}


def model_phase(rng, smi: str, zero_counts, read_counts, device="cuda",
                full_cfg=None) -> tuple:
    """Phase 5.  (a) Every arch of ``repro_torch.configs.ARCH_IDS``,
    reduced, float32: the same weights (from a generator seeded by
    ``rng``) on the card and on the CPU, forward logits, the prefill's
    last logits and greedy decode steps within ``MODEL_F32_TOL``, tokens
    equal.  (b) qwen3-8b at its published config (``full_cfg`` shrinks
    it for a rehearsal), bf16, weights from a seeded generator on the
    card, answering four requests as ``repro.serve.engine`` does at its
    boundary: ingress (four lipsum prompts packed, validated by one
    ``ragged_scan`` launch, byte tokens padded to the 512 bucket), one
    prefill and ``MODEL_STEPS`` greedy decode steps in a context of 640,
    egress (the generated byte values through blockparallel
    ``transcode`` to UTF-16).  Checked: the launch count, the greedy
    tokens against a teacher-forced forward, and bf16 against an f32
    copy of the same weights at depth ``MODEL_DEPTH_CHECK``.  Returns
    ``(report, launches, model)``: the full-width model serves phase 6
    before the caller frees it."""
    import torch
    import repro_torch
    from repro_torch import configs
    from repro_torch.core import packing
    from repro_torch.core import transcode as tc
    from repro_torch.data.tokenizer import (BOS_ID, EOS_ID, N_SPECIAL,
                                            ByteTokenizer)
    from repro_torch.models import registry
    from repro_torch.serve import kvcache, serve_step

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def clock_ms(fn):
        """Host clock around ``fn`` and a synchronise: ``(result, ms)``."""
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    report = {}
    # (a) every arch, reduced, float32, TF32 off: card = CPU.
    torch.backends.cuda.matmul.allow_tf32 = False
    reduced = {}
    for arch in configs.ARCH_IDS:
        seed = int(rng.integers(2**31))
        fam, cfg, host = registry.get(
            arch, reduced=True, device="cpu",
            generator=torch.Generator().manual_seed(seed))
        card = registry.build(cfg, device=dev)
        card.load_state_dict(host.state_dict())
        b, s = 2, 16
        toks = rng.integers(3, cfg.vocab, (b, s)).astype(np.int32)
        lens = np.array([s, s - 5], np.int32)
        frames = (rng.standard_normal((b, cfg.n_audio_frames, cfg.d_model))
                  .astype(np.float32) if fam == "encdec" else None)
        want = _reduced_run(host, fam, cfg, toks, lens, frames, "cpu")
        got = _reduced_run(card, fam, cfg, toks, lens, frames, dev)
        pairs = [("forward", got[0], want[0]), ("prefill", got[1], want[1])]
        for k, ((gt, gl), (wt, wl)) in enumerate(zip(got[2], want[2])):
            require(torch.equal(gt, wt), "reduced decode tokens", arch, k)
            pairs.append((f"decode {k}", gl, wl))
        for what, g, w in pairs:
            require(torch.allclose(g, w, **MODEL_F32_TOL), "reduced card vs "
                    "cpu", arch, what, float((g - w).abs().max()))
        reduced[arch] = max(float((g - w).abs().max()) for _, g, w in pairs)
    report["reduced_max_abs_err"] = reduced
    log(f"phase 5: {len(reduced)} archs reduced f32 (TF32 off), card = cpu "
        f"within atol=rtol={MODEL_F32_TOL['atol']:g}: forward, prefill, "
        f"{MODEL_REDUCED_STEPS} greedy steps, tokens equal; max abs err "
        f"{max(reduced.values()):.3g}")

    # (b) qwen3-8b, full width and depth, bf16, four requests.
    cfg = full_cfg or configs.get_config(MODEL_ARCH)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    model, build_ms = clock_ms(lambda: registry.build(
        cfg, device=dev, generator=gen).requires_grad_(False))
    n_params = model.param_count()
    raws = [inputs.utf8_buffer(lang, int(rng.integers(
        MODEL_PROMPT_BYTES[0], MODEL_PROMPT_BYTES[1] + 1)), rng)
        for lang in MODEL_LANGS]
    texts = [bytes(raw).decode("utf-8") for raw in raws]
    b, ctx = len(raws), MODEL_BUCKET + MODEL_NEW
    prefill = serve_step.make_prefill(model, "lm")
    decode = serve_step.make_decode(model, "lm")
    tokenizer = ByteTokenizer()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # held before the path runs: the weights and what earlier phases keep
    before = torch.cuda.memory_allocated() if cuda else None
    sync()
    zero_counts()

    def ingress():
        pk = packing.pack_documents(
            raws, dtype=np.uint8, doc_tiles=-(-MODEL_BUCKET // BLOCK),
            pad_to_docs=b)
        _counts, statuses = repro_torch.ragged_scan(
            pk.data, pk.offsets, pk.lengths, src_format="utf8",
            dst_format="utf16", device=dev)
        toks = torch.zeros((b, MODEL_BUCKET), dtype=torch.int32, device=dev)
        lens = []
        for r, raw in enumerate(raws):
            ids = tokenizer.encode(torch.from_numpy(raw).to(dev))
            toks[r, 0] = BOS_ID
            toks[r, 1: 1 + len(ids)] = ids
            lens.append(1 + len(ids))
        return statuses.cpu().numpy(), toks, torch.tensor(
            lens, dtype=torch.int32, device=dev)

    (statuses, toks, lens), ingress_ms = clock_ms(ingress)
    require(bool((statuses == -1).all()), "ingress statuses", statuses)
    state = kvcache.init_state(model, cfg, b, ctx)
    (last, state), prefill_first_ms = clock_ms(
        lambda: prefill(model, toks, lens, state))
    cur = last.argmax(-1).to(torch.int32)
    gen_toks, gen_logits, pos, step_ms = [cur], [last], lens.clone(), []
    for _ in range(MODEL_STEPS):
        (cur, logits, state), ms = clock_ms(
            lambda: decode(model, cur[:, None], pos, state, None))
        pos = pos + 1
        gen_toks.append(cur)
        gen_logits.append(logits)
        step_ms.append(ms)
    gen_np = torch.stack(gen_toks, 1).cpu().numpy()

    def to_wire(vals):
        """UTF-8 byte values -> UTF-16LE wire bytes, as the engine's
        egress (``engine.py:985-1001``)."""
        res = repro_torch.transcode(
            torch.from_numpy(vals).to(dev), "utf16", src_format="utf8",
            n_valid=len(vals), strategy="blockparallel", device=dev)
        wire = tc.units_to_utf16le_bytes(res.buffer[: int(res.count)],
                                         device=dev)
        return bytes(wire.cpu().numpy().astype(np.uint8))

    def egress():
        wires = []
        for g in gen_np:
            g = g[(g >= 0) & (g != EOS_ID)]
            vals = g - N_SPECIAL
            vals = vals[(vals >= 0) & (vals < 256)].astype(np.int32)
            wires.append((vals, to_wire(vals)))
        return wires

    wires, egress_ms = clock_ms(egress)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    log(f"phase 5: model path launches {launches}")
    require(launches == {"rcount": 1}, "model path launches", launches)
    for vals, wire in wires:
        try:
            text = bytes(vals.astype(np.uint8)).decode("utf-8")
        except UnicodeDecodeError:
            continue                  # the engine's egress keeps a prefix
        require(wire == text.encode("utf-16-le"), "egress vs CPython")
    # Random weights seldom emit a byte token (256 of 151,936 ids), so the
    # same egress also runs on responses as long as the prompts (their
    # bytes echoed): times at a real size, checked against CPython.
    echo, echo_ms = clock_ms(lambda: [to_wire(raw.astype(np.int32))
                                      for raw in raws])
    for wire, text in zip(echo, texts):
        require(wire == text.encode("utf-16-le"), "echo egress vs CPython")

    # Self-consistency: the generated tokens against the argmax of one
    # teacher-forced forward over prompt + generated tokens, wherever its
    # top-2 margin passes the bf16 tolerance; the decode path's logits
    # against the forward's.
    n_gen = MODEL_STEPS + 1
    lens_np = lens.cpu().numpy()
    full = torch.zeros((b, int(lens_np.max()) + MODEL_STEPS),
                       dtype=torch.int32, device=dev)
    for r, n in enumerate(lens_np):
        full[r, :n] = toks[r, :n]
        full[r, n: n + MODEL_STEPS] = torch.from_numpy(gen_np[r, :MODEL_STEPS])
    with torch.no_grad():
        tf_all = model(full)[0]
    at = (lens.long()[:, None] - 1
          + torch.arange(n_gen, device=dev)[None, :])
    tf = torch.gather(tf_all, 1, at[:, :, None].expand(-1, -1, cfg.vocab))
    del tf_all
    top2 = tf.topk(2, -1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu()
    agree = (tf.argmax(-1).cpu().numpy() == gen_np)
    decided = (margin > BF16_LOGIT_TOL).numpy()
    tf_err = float((torch.stack(gen_logits, 1) - tf).abs().max())
    del tf, gen_logits
    require(tf_err <= BF16_LOGIT_TOL, "decode vs teacher-forced logits",
            tf_err)
    require(bool(agree[decided].all()), "greedy vs teacher-forced tokens",
            np.argwhere(decided & ~agree).tolist())

    prefill_ms = statistics.median(clock_ms(lambda: prefill(
        model, toks, lens, kvcache.init_state(model, cfg, b, ctx)))[1]
        for _ in range(MODEL_PREFILL_REPS))
    busy = {}
    if cuda:
        st = kvcache.init_state(model, cfg, b, ctx)
        busy["prefill"] = device_busy(lambda: prefill(model, toks, lens, st))
        busy["decode"] = device_busy(lambda: decode(
            model, gen_toks[-1][:, None], pos, st, None))
    busy_ms = {k: v["busy_ms"] for k, v in busy.items()}
    bounds = model_bounds(cfg, n_params, b, MODEL_BUCKET,
                          kvcache.state_bytes(cfg, b, ctx))
    decode_ms = statistics.median(step_ms)
    del state
    if cuda:
        del st
        torch.cuda.empty_cache()

    # bf16 against an f32 copy of the same weights, at depth 2.
    c2 = dataclasses.replace(cfg, n_layers=MODEL_DEPTH_CHECK)
    m16 = registry.build(c2, device=dev, generator=torch.Generator(
        device=dev).manual_seed(int(rng.integers(2**31)))).requires_grad_(
            False)
    m32 = registry.build(dataclasses.replace(c2, dtype="float32"),
                         device="meta").to_empty(device=dev)
    m32.load_state_dict(m16.state_dict())
    with torch.no_grad():
        l16, l32 = m16(toks)[0], m32(toks)[0]
    rel = float((l16 - l32).norm() / l32.norm())
    mx = float((l16 - l32).abs().max())
    del m16, m32, l16, l32
    require(rel <= BF16_REL_RMS and mx <= BF16_LOGIT_TOL, "bf16 vs f32",
            rel, mx)

    report[MODEL_ARCH] = {
        "config": dataclasses.asdict(cfg), "params": n_params,
        "build_ms": build_ms, "batch": b, "bucket": MODEL_BUCKET,
        "context": ctx, "prompt_bytes": [len(r) for r in raws],
        "prompt_tokens": lens_np.tolist(),
        "prompt_chars": [len(t) for t in texts],
        "ingress_ms": ingress_ms, "prefill_first_ms": prefill_first_ms,
        "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
        "decode_ms": decode_ms, "egress_ms": egress_ms,
        "egress_bytes": [len(v) for v, _ in wires],
        "egress_echo_ms": echo_ms,
        "device_busy": busy, "peak_memory_bytes": peak,
        "memory_before_bytes": before,
        "launches": launches, **bounds,
        "decode_vs_teacher_forced_max_abs": tf_err,
        "tokens_agree": int(agree.sum()), "tokens": int(agree.size),
        "tokens_decided": int(decided.sum()),
        "min_margin": float(margin.min()),
        "bf16_vs_f32_rel_rms": rel, "bf16_vs_f32_max_abs": mx,
        "bf16_tolerance": {"logits_abs": BF16_LOGIT_TOL,
                           "rel_rms": BF16_REL_RMS}}
    peak_gb = ("not measured" if peak is None else
               f"{peak / 1e9:.2f} GB ({before / 1e9:.2f} GB held before "
               f"the path)")
    log(f"phase 5: {MODEL_ARCH} {cfg.n_layers} layers d_model "
        f"{cfg.d_model} vocab {cfg.vocab}, {n_params} parameters "
        f"({cfg.dtype}), built in {build_ms:.0f} ms; 4 requests "
        f"{[len(r) for r in raws]} bytes ({', '.join(MODEL_LANGS)}), "
        f"tokens {lens_np.tolist()}")
    log(f"phase 5: ingress {ingress_ms:.3f} ms (one ragged_scan); prefill "
        f"{b} x {MODEL_BUCKET} {prefill_ms:.2f} ms (first call "
        f"{prefill_first_ms:.2f}; device busy {busy_ms.get('prefill')}) "
        f"bound "
        f"{bounds['prefill_bound_ms']:.2f} ms "
        f"({bounds['prefill_flops'] / 1e12:.2f} TFLOP at 989 TFLOP/s); "
        f"decode {decode_ms:.2f} ms a step (median of {MODEL_STEPS}; "
        f"device busy {busy_ms.get('decode')}) bound "
        f"{bounds['decode_bound_ms']:.3f} ms "
        f"({bounds['decode_bytes'] / 1e9:.2f} GB at 3.35 TB/s); egress "
        f"{egress_ms:.3f} ms ({[len(v) for v, _ in wires]} bytes; the "
        f"prompts echoed: {echo_ms:.3f} ms); peak "
        f"{peak_gb}  [{smi}]")
    log(f"phase 5: {int(agree.sum())}/{agree.size} greedy tokens = "
        f"teacher-forced argmax, all {int(decided.sum())} with a top-2 "
        f"margin > {BF16_LOGIT_TOL} (min margin {float(margin.min()):.4f}); "
        f"decode vs teacher-forced logits max abs {tf_err:.4f}; bf16 vs "
        f"f32 at depth {MODEL_DEPTH_CHECK}: rel rms {rel:.5f} "
        f"(<= {BF16_REL_RMS}), max abs {mx:.4f} (<= {BF16_LOGIT_TOL})")
    for step, prof in busy.items():
        log(f"phase 5: {step} on the device: {prof['launches']} kernel "
            f"launches, busy {prof['busy_ms']} ms; most time: "
            + "; ".join(f"{k} {ms:.3f} ms x{n}" for k, ms, n in prof["top"]))
    return report, launches, model


# ---------------------------------------------------------------------------
# Phase 6: the serve engine.


def engine_trace(rng):
    """The phase's 16 requests, as ``(request kwargs, text or None)``:
    eight UTF-8 lipsum prompts (two each of ``MODEL_LANGS``, sizes spread
    log-uniformly over ``ENGINE_PROMPT_BYTES``), three UTF-16LE, two
    UTF-32LE and one Latin-1 prompt of the same profiles (their UTF-8 at
    most 500 bytes), one UTF-8 prompt with a 0xFF byte under ``strict``
    and one with a truncated 3-byte sequence under ``replace``.
    ``max_new`` and ``out_encoding`` cycle over ``ENGINE_MAX_NEW`` and
    the four encodings."""
    sizes = np.geomspace(*ENGINE_PROMPT_BYTES, 8).round().astype(int)
    specs = []
    for k, n in enumerate(sizes):
        lang = MODEL_LANGS[k % len(MODEL_LANGS)]
        raw = bytes(inputs.utf8_buffer(lang, int(n), rng))
        specs.append((dict(prompt_bytes=raw), raw.decode("utf-8")))
    for enc, lang, n in (("utf-16-le", "arabic", 300),
                         ("utf-16-le", "chinese", 450),
                         ("utf-16-le", "emoji", 200),
                         ("utf-32-le", "chinese", 240),
                         ("utf-32-le", "emoji", 500)):
        text = bytes(inputs.utf8_buffer(lang, n, rng)).decode("utf-8")
        specs.append((dict(prompt_bytes=text.encode(enc), in_encoding=enc),
                      text))
    # Latin-1: ASCII lipsum with every 8th character from U+00C0-U+00FF.
    chars = list(bytes(inputs.utf8_buffer("latin", 400, rng)).decode())
    for i in range(0, len(chars), 8):
        chars[i] = chr(int(rng.integers(0xC0, 0x100)))
    text = "".join(chars)
    specs.append((dict(prompt_bytes=text.encode("latin-1"),
                       in_encoding="latin-1"), text))
    bad = bytearray(inputs.utf8_buffer("latin", 120, rng))
    bad[57] = 0xFF
    specs.append((dict(prompt_bytes=bytes(bad)), None))
    cut = bytes(inputs.utf8_buffer("arabic", 150, rng)).rstrip(b" ")
    cut = cut + b" \xe4\xb8 " + cut[:40].decode("utf-8", "ignore").encode()
    specs.append((dict(prompt_bytes=cut, errors="replace"), None))
    for k, (kw, _text) in enumerate(specs):
        kw["max_new"] = ENGINE_MAX_NEW[k % len(ENGINE_MAX_NEW)]
        kw["out_encoding"] = ENGINE_ENCODINGS[k % len(ENGINE_ENCODINGS)]
    return specs


def _expected(kw: dict):
    """What CPython's codecs make of a request: ``(ok, error_offset,
    sanitized, the UTF-8 the engine serves)``."""
    enc, width = kw.get("in_encoding", "utf-8"), {
        "utf-8": 1, "utf-16-le": 2, "utf-32-le": 4, "latin-1": 1}[
            kw.get("in_encoding", "utf-8")]
    wire = kw["prompt_bytes"]
    try:
        wire.decode(enc)
        off = -1
    except UnicodeDecodeError as e:
        off = e.start // width
    if off >= 0 and kw.get("errors", "strict") == "strict":
        return False, off, b"", None
    served = wire.decode(enc, "replace").encode("utf-8")
    return True, off, served if off >= 0 else b"", served


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def engine_phase(model, rng, smi: str, zero_counts, read_counts, faults,
                 device="cuda") -> tuple:
    """Phase 6.  ``repro_torch.Engine`` serving the 16 requests of
    :func:`engine_trace` through ``model`` (qwen3-8b at full width in the
    chip run) with the reference's defaults (``max_batch`` 8,
    ``max_prompt`` 512, ``max_new`` 128, the continuous scheduler), all
    submitted up front, then one drain under an unarmed fault harness
    with the launch counts set to 0 just before and read just after;
    then the engine's egress on the eight UTF-8 prompts echoed in each
    other encoding, counted the same way on its own.  Checked: codes, offsets and sanitized prompts against CPython; no
    fallback, retry or breaker transition; launches (rcount, ronepass,
    onepass and nothing else) equal to the harness's calls of their
    wrappers; a refill mid-wave; every slot's tokens against a
    teacher-forced forward where its top-2 margin passes
    ``BF16_LOGIT_TOL``; egress against CPython, and the echo's onepass
    launches equal to its calls (one a call); one graph decode step
    against ``ENGINE_EAGER_REPS`` eager steps, each from a fresh copy of
    the same state.  Returns ``(report, launches, served)``: the drain's
    and the echo's launches together, and what the drain served
    (:func:`served_by`), which phase 7's sharded engine must equal."""
    import torch
    from repro_torch.data.tokenizer import BOS_ID, EOS_ID, N_SPECIAL
    from repro_torch.serve import engine as E
    from repro_torch.serve import kvcache

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, n_params = model.cfg, model.param_count()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    specs = engine_trace(rng)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    eng = E.Engine(model, cfg, "lm", model, device=dev)
    B = eng.max_batch
    # Instrumentation, on this engine instance only: every slot's tokens,
    # and the host time of each decode step, prefill, ingress chunk and
    # egress call (each already ends in a device-to-host copy, but the
    # prefill, which gets a synchronise).
    tokens, times = {}, {"decode": [], "prefill": [], "ingress": [],
                         "egress": []}
    finish, step_fn = eng._finish_slot, eng._decode_step
    prefill_fn, ingress_fn, egress_fn = (eng._prefill_call,
                                         eng._ingress_chunk, eng._egress)

    def timed(kind, fn, label=None):
        def run(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            if kind == "prefill":
                sync()
            ms = (time.perf_counter() - t0) * 1e3
            times[kind].append(ms if label is None else [label(*a), ms])
            return out
        return run

    def finish_slot(slots, j):
        tokens[slots[j].ticket] = list(slots[j].tokens)
        finish(slots, j)

    eng._finish_slot = finish_slot
    eng._decode_step = timed("decode", step_fn)
    eng._prefill_call = timed("prefill", prefill_fn,
                              lambda toks, lens: int(toks.shape[1]))
    eng._ingress_chunk = timed(
        "ingress", ingress_fn,
        lambda group, bound, take: [eng._group_name(group), bound,
                                    len(take)])
    eng._egress = timed("egress", egress_fn,
                        lambda ids, enc: [enc, int(len(ids))])

    submit_t, tickets = {}, []
    for kw, _text in specs:
        t = time.monotonic()
        tickets.append(eng.submit(E.Request(**kw)))
        submit_t[tickets[-1]] = t
    sync()
    zero_counts()
    with faults.harness() as h:
        t0 = time.perf_counter()
        eng.drain()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    calls = dict(h.calls)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    results = [eng.poll(t) for t in tickets]
    log(f"phase 6: engine path launches {launches}; fault-hook calls "
        f"{calls}")
    want = {name: calls.get(point, 0) for name, point in (
        ("rcount", faults.KERNEL_RAGGED_SCAN),
        ("ronepass", faults.KERNEL_RAGGED),
        ("onepass", faults.KERNEL_ONEPASS))}
    require(launches == {k: v for k, v in want.items() if v},
            "engine launches vs the wrappers' calls", launches, calls)
    require(all(want.values()), "engine path: every ingress kernel",
            want)

    # Codes against CPython; no hidden fallback.
    for (kw, _text), res in zip(specs, results):
        ok, off, sanitized, _served = _expected(kw)
        code = E.OK if ok else E.REJECTED_INVALID
        require(res is not None and (res.ok, res.code, res.error_offset,
                                     res.sanitized_prompt)
                == (ok, code, off, sanitized), "engine result vs CPython",
                kw.get("in_encoding", "utf-8"), kw.get("errors", "strict"),
                None if res is None else (res.ok, str(res.code),
                                          res.error_offset, res.error))
    hidden = {k: v for k, v in eng.counters.items()
              if k in ("fallback", "retries") or k.startswith("breaker_")}
    require(not any(hidden.values()), "engine fallback/retries/breaker",
            hidden)

    # Continuous batching: an admit at a step > 0 into a slot that a
    # finish freed before it.
    freed = {}
    refills = []
    for kind, ticket, slot, step, _wall in eng.events:
        if kind == "finish":
            freed[slot] = step
        elif kind == "admit" and step > 0 and slot in freed:
            refills.append([ticket, slot, step])
    require(bool(refills), "engine: no refill mid-wave", list(eng.events))
    admit_wall = {t: w for kind, t, _s, _st, w in eng.events
                  if kind == "admit"}
    ttft_ms = {t: (admit_wall[t] - submit_t[t]) * 1e3 for t in admit_wall}

    # Tokens against a teacher-forced forward over prompt + generated
    # tokens, four rows at a time.
    served = [(t, _expected(kw)[3]) for t, (kw, _x) in zip(tickets, specs)
              if t in tokens]
    agree = decided = n_tok = 0
    min_margin = float("inf")
    for i in range(0, len(served), 4):
        rows = served[i: i + 4]
        seqs = []
        for t, prompt in rows:
            ids = [BOS_ID] + [b + N_SPECIAL for b in prompt]
            seqs.append((ids, tokens[t]))
        width = max(len(ids) + len(gen) - 1 for ids, gen in seqs)
        full = torch.zeros((len(seqs), width), dtype=torch.int32,
                           device=dev)
        for r, (ids, gen) in enumerate(seqs):
            row = ids + gen[:-1]
            full[r, :len(row)] = torch.tensor(row, dtype=torch.int32)
        with torch.no_grad():
            logits = model(full)[0]
        for r, (ids, gen) in enumerate(seqs):
            tf = logits[r, len(ids) - 1: len(ids) - 1 + len(gen)].float()
            top2 = tf.topk(2, -1).values
            margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            same = tf.argmax(-1).cpu().numpy() == np.asarray(gen)
            sure = margin > BF16_LOGIT_TOL
            require(bool(same[sure].all()), "engine tokens vs "
                    "teacher-forced", np.argwhere(sure & ~same).tolist())
            agree += int(same.sum())
            decided += int(sure.sum())
            n_tok += len(gen)
            min_margin = min(min_margin, float(margin.min()))
        del logits

    # Egress: the responses whose bytes decode, against CPython (random
    # weights seldom emit a byte token, so most responses are empty).
    egress_checked = 0
    for (kw, _text), t, res in zip(specs, tickets, results):
        if t not in tokens:
            continue
        g = np.asarray(tokens[t], np.int64)
        g = g[(g >= 0) & (g != EOS_ID)] - N_SPECIAL
        vals = bytes(g[(g >= 0) & (g < 256)].astype(np.uint8))
        try:
            text = vals.decode("utf-8")
        except UnicodeDecodeError:
            continue
        enc = kw["out_encoding"]
        require(res.text_bytes == text.encode(
            enc, "replace" if enc == "latin-1" else "strict"),
            "engine egress vs CPython", enc)
        egress_checked += len(vals) > 0
    # The egress at prompt sizes: the eight UTF-8 prompts' bytes, as
    # tokens, through the engine's egress in each other encoding, with
    # the launch counts set to 0 just before and read just after.
    echo = {enc: [] for enc in ENGINE_ENCODINGS[1:]}
    sync()
    zero_counts()
    with faults.harness() as he:
        for enc in echo:
            for kw, text in specs[:8]:
                ids = np.frombuffer(text.encode(), np.uint8).astype(
                    np.int64) + N_SPECIAL
                t0 = time.perf_counter()
                wire = egress_fn(ids, enc)
                echo[enc].append((time.perf_counter() - t0) * 1e3)
                require(wire == text.encode(
                    enc, "replace" if enc == "latin-1" else "strict"),
                    "engine echo egress vs CPython", enc)
    echo_launches = read_counts()
    echo_calls = dict(he.calls)
    n_echo = sum(len(v) for v in echo.values())
    log(f"phase 6: echo egress launches {echo_launches}; fault-hook calls "
        f"{echo_calls}")
    require(echo_launches == {"onepass": n_echo}
            and echo_calls == {faults.KERNEL_ONEPASS: n_echo},
            "echo egress launches vs the wrappers' calls", echo_launches,
            echo_calls)

    # The graph against the eager step, from copies of the same state:
    # one graph step, then ENGINE_EAGER_REPS eager steps, each from a
    # fresh copy, each held to the graph's.
    cur = rng.integers(N_SPECIAL, N_SPECIAL + 256, B).astype(np.int32)
    pos = np.full(B, ENGINE_CHECK_POS, np.int32)
    snapshot = _clone_tree(eng._live)
    graph = eng._graph is not None
    nxt_g = step_fn(cur, pos)
    logits_g = eng._logits.float() if graph else None
    tok = torch.from_numpy(cur[:, None]).to(dev)
    pos_t = torch.from_numpy(pos).to(dev)
    eager_ms, graph_err = [], 0.0
    for _ in range(ENGINE_EAGER_REPS):
        state = _clone_tree(snapshot)
        sync()
        t0 = time.perf_counter()
        nxt_e, logits_e, _ = eng._decode_fn(model, tok, pos_t, state, None)
        sync()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        require(np.array_equal(nxt_g, nxt_e.cpu().numpy()),
                "graph vs eager decode tokens")
        if graph:
            graph_err = max(graph_err, float(
                (logits_g - logits_e.float()).abs().max()))
        del state, logits_e
    if not graph:
        graph_err = None
    require(not cuda or (graph and graph_err <= BF16_LOGIT_TOL),
            "graph vs eager decode logits", graph_err)
    busy = device_busy(lambda: step_fn(cur, pos)) if cuda else {}
    del snapshot, logits_g

    bounds = model_bounds(cfg, n_params, B, eng.max_prompt,
                          kvcache.state_bytes(cfg, B, eng._ctx))
    n_gen = sum(len(v) for v in tokens.values())
    decode_ms = statistics.median(times["decode"])
    lat = {k: eng.counters[k] for k in ("latency_p50_ms",
                                        "latency_p99_ms")}
    report = {
        "requests": len(specs), "max_batch": B, "context": eng._ctx,
        "wall_ms": wall_ms, "requests_per_s": len(specs) / wall_ms * 1e3,
        "generated_tokens": n_gen,
        "tokens_per_s": n_gen / wall_ms * 1e3,
        "decode_steps": len(times["decode"]),
        "decode_ms": decode_ms, "decode_step_ms": times["decode"],
        "decode_eager_ms": statistics.median(eager_ms),
        "decode_eager_step_ms": eager_ms, "graph": graph,
        "decode_bound_ms": bounds["decode_bound_ms"],
        "decode_bytes": bounds["decode_bytes"],
        "decode_busy": busy, "graph_vs_eager_max_abs": graph_err,
        "capture_ms": eng.capture_ms,
        "prefill_ms": times["prefill"], "ingress_ms": times["ingress"],
        "egress_ms": times["egress"], "egress_checked": egress_checked,
        "egress_echo_ms": echo, "egress_echo_launches": echo_launches,
        "ttft_ms": {str(t): ms for t, ms in ttft_ms.items()},
        **lat, "peak_memory_bytes": peak, "launches": launches,
        "fault_hook_calls": calls, "refills_mid_wave": refills,
        "counters": dict(eng.counters), "tokens_agree": agree,
        "tokens": n_tok, "tokens_decided": decided,
        "min_margin": min_margin,
        "results": [[str(r.code), r.error_offset, len(r.text_bytes)]
                    for r in results]}
    peak_gb = "not measured" if peak is None else f"{peak / 1e9:.2f} GB"
    log(f"phase 6: Engine({MODEL_ARCH}, max_batch {B}, max_prompt "
        f"{eng.max_prompt}, max_new {eng.max_new}) served {len(specs)} "
        f"requests in {wall_ms:.1f} ms ({report['requests_per_s']:.2f} "
        f"requests/s, {n_gen} tokens, {report['tokens_per_s']:.1f} "
        f"tokens/s); codes = CPython's; fallback/retries/breaker 0; "
        f"{len(refills)} refills mid-wave  [{smi}]")
    log(f"phase 6: decode {'graph' if graph else 'eager'} "
        f"{decode_ms:.3f} ms a step (median of {len(times['decode'])}: "
        f"copy in, replay, copy out), eager {statistics.median(eager_ms):.2f}"
        f" ms a step (median of {len(eager_ms)}, each from a fresh copy of "
        f"the state; {min(eager_ms):.2f}-{max(eager_ms):.2f}), bound "
        f"{bounds['decode_bound_ms']:.3f} ms "
        f"({bounds['decode_bytes'] / 1e9:.2f} GB at 3.35 TB/s); device "
        f"busy {busy.get('busy_ms')} ms in {busy.get('launches')} "
        f"launches; capture {eng.capture_ms} ms; graph vs eager logits max "
        f"abs {graph_err}, tokens equal  [{smi}]")
    log(f"phase 6: prefill ms [bucket, ms] {times['prefill']}; ingress "
        f"[group, bucket, prompts, ms] {times['ingress']}; egress "
        f"[encoding, tokens, ms] {times['egress']} ({egress_checked} "
        f"responses with bytes)  [{smi}]")
    log(f"phase 6: echo egress, the 8 UTF-8 prompts "
        f"({[len(t.encode()) for _kw, t in specs[:8]]} bytes) a call, "
        f"{n_echo} onepass launches: " + "; ".join(
            f"{enc} median {statistics.median(v):.3f} ms "
            f"({min(v):.3f}-{max(v):.3f})" for enc, v in echo.items())
        + f"  [{smi}]")
    log(f"phase 6: time to first token ms "
        f"{[round(ms, 1) for ms in ttft_ms.values()]}; latency p50 "
        f"{lat['latency_p50_ms']:.1f} ms, p99 {lat['latency_p99_ms']:.1f} "
        f"ms; peak {peak_gb}; {agree}/{n_tok} tokens = teacher-forced "
        f"argmax, all {decided} with a margin > {BF16_LOGIT_TOL}  [{smi}]")
    served = served_by(specs, results, tokens)
    del eng
    if cuda:
        torch.cuda.empty_cache()
    total = dict(launches)
    for name, n in echo_launches.items():
        total[name] = total.get(name, 0) + n
    return report, total, served


def served_by(specs, results, tokens) -> dict:
    """What an engine served for phase 6's trace: the requests, each
    result's ``(ok, code, error_offset, sanitized_prompt, text_bytes)``
    and every slot's tokens by ticket."""
    return {"specs": specs, "tokens": dict(tokens),
            "results": [None if r is None else (
                r.ok, str(r.code), r.error_offset, r.sanitized_prompt,
                r.text_bytes) for r in results]}


# ---------------------------------------------------------------------------
# Phase 7: the sharded path.


def cell_docs(fmt: str, text_cps: np.ndarray, rng) -> list:
    """``SHARD_CELL_DOCS`` documents of one source format for phase 7's
    other cells: lipsum slices of 0-3,000 characters, every 50th empty,
    and an invalid unit (``BAD_UNITS``) in every 16th."""
    bad = BAD_UNITS[fmt]
    docs = []
    for i in range(SHARD_CELL_DOCS):
        n = 0 if i % 50 == 49 else int(rng.integers(1, 3000))
        lo = int(rng.integers(0, len(text_cps) - n))
        d = encode(text_cps[lo: lo + n], fmt).copy()
        if i % 16 == 5 and n:
            d[int(rng.integers(0, len(d)))] = bad[i % len(bad)]
        docs.append(d)
    return docs


def valid_utf16_units(b: np.ndarray) -> int:
    """UTF-16 units of valid UTF-8 bytes: one per character, two per
    4-byte character."""
    return int(((b & 0xC0) != 0x80).sum() + (b >= 0xF0).sum())


def hold_split(want, got, plan, docs, *ctx):
    """A sharded UTF-8 -> UTF-16 result against the unsharded one under
    ``strict``: offsets, counts and statuses equal, and the buffer equal
    but past the first error of each document that the plan split and
    that holds an error (the reference's strict caveat).  Returns the
    documents relaxed."""
    for name in ("offsets", "counts", "statuses"):
        require(equal(getattr(want, name), getattr(got, name)),
                "sharded split", name, *ctx)
    require(want.buffer.shape == got.buffer.shape
            and want.buffer.dtype == got.buffer.dtype, "sharded split "
            "buffer shape", *ctx)
    keep = np.ones(want.buffer.shape[0], bool)
    off, cnt = want.offsets.cpu().numpy(), want.counts.cpu().numpy()
    st = want.statuses.cpu().numpy()
    relaxed = []
    for d in range(plan.n_docs):
        if st[d] >= 0 and int((plan.frag_doc == d).sum()) > 1:
            lo = int(off[d]) + valid_utf16_units(docs[d][: st[d]])
            keep[lo: int(off[d]) + int(cnt[d])] = False
            relaxed.append(d)
    a, b = want.buffer.cpu().numpy(), got.buffer.cpu().numpy()
    require(np.array_equal(a[keep], b[keep]), "sharded split buffer",
            *ctx)
    return relaxed


def shard_phase(model, served, docs, pk, big, text_cps, rng, smi: str,
                zero_counts, read_counts, faults, out_dir: Path,
                device="cuda") -> tuple:
    """Phase 7, the sharded path (``core/shard.py``: one ragged launch
    per shard, each shard on a CUDA stream of its own), with the launch
    counts set to 0 just before each counted drive and read just after:

      * phase 3's ragged batch (``docs``, packed ``pk``) through
        ``ragged_transcode(strategy="sharded")`` at ``SHARD_COUNTS``
        shards under strict and replace, and ``scan_ragged_sharded``:
        each equal to the unsharded call, exactly n ronepass (or rcount)
        launches and nothing else; ``SHARD_REPEATS`` more calls at 8
        shards, each equal; one 8-shard call under ``torch.profiler``
        (the streams its launches ran on, and whether they overlapped);
      * ``big`` (phase 3's 64 MiB UTF-8 buffer) as one document among
        three small ones at 4 shards, so cuts land inside it: valid text
        under both policies and invalid units at tile starts under
        replace equal to unsharded, under strict held by
        :func:`hold_split`;
      * UTF-16, UTF-32 and Latin-1 batches (:func:`cell_docs`) to UTF-8
        at 4 shards, both policies, equal to unsharded;
      * supervision: the reference's 8 -> 7 -> 6 replan at full width
        (``shard.launch`` failing at calls 1-4), and a hang past the
        watchdog, then a retried success;
      * the feeder: the batch in ``SHARD_WAVES`` waves of 4 shards, each
        gathered wave equal to the unsharded transcode of that wave, and
        a ``feed.stage`` fault at wave 1;
      * ``Engine(ingress_shards=4)`` on ``model`` serving phase 6's trace,
        equal to what phase 6's engine ``served``, rcount and ronepass
        launches 4 per chunk;
      * on the card, the times of the sharded call and scan, split into
        plan (host), pinning, the copy in, the kernels on their streams
        and the gather, beside the unsharded calls.

    Returns ``(report, launches)``."""
    import threading

    import torch
    import repro_torch
    from repro_torch.core import packing, recovery, shard
    from repro_torch.data import shard_feed
    from repro_torch.kernels import ragged_transcode as rt
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.serve import engine as E

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    launches, report = {}, {}

    def counted(fn):
        """``fn()`` with the launch counts set to 0 just before and read
        just after; adds them to the phase's launches."""
        sync()
        zero_counts()
        out = fn()
        got = read_counts()
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        return out, got

    def same(want, got, *ctx):
        for name, a, b in zip(want._fields, want, got):
            require(equal(a, b), "sharded vs unsharded", name, *ctx)

    meshes = {n: launch_mesh.make_transcode_mesh(n, device=dev)
              for n in SHARD_COUNTS}
    args = (pk.data, pk.offsets, pk.lengths)
    x = torch.from_numpy(pk.data).to(dev)

    def unsharded(data, offsets, lengths, **kw):
        return repro_torch.ragged_transcode(
            torch.from_numpy(data).to(dev), offsets, lengths, device=dev,
            **kw)

    def sharded(data, offsets, lengths, n, **kw):
        return repro_torch.ragged_transcode(
            data, offsets, lengths, strategy="sharded",
            shard_mesh=meshes[n], **kw)

    # Full width: phase 3's batch at every shard count.
    want = {e: unsharded(*args, errors=e) for e in ("strict", "replace")}
    per_call = {}
    for errors in ("strict", "replace"):
        for n in SHARD_COUNTS:
            got, cnt = counted(lambda: sharded(*args, n, errors=errors))
            require(cnt == {"ronepass": n}, "sharded launches", n, errors,
                    cnt)
            same(want[errors], got, n, errors)
            per_call[f"transcode {errors} n={n}"] = cnt
    want_scan = repro_torch.ragged_scan(x, pk.offsets, pk.lengths,
                                        device=dev)
    for n in SHARD_COUNTS:
        got, cnt = counted(lambda: shard.scan_ragged_sharded(
            *args, mesh=meshes[n]))
        require(cnt == {"rcount": n}, "sharded scan launches", n, cnt)
        for a, b in zip(want_scan, got):
            require(equal(a, b), "sharded scan vs ragged_scan", n)
        per_call[f"scan n={n}"] = cnt
    _out, cnt = counted(lambda: [
        same(want["replace"], sharded(*args, 8, errors="replace"),
             "repeat", r) for r in range(SHARD_REPEATS)])
    require(cnt == {"ronepass": 8 * SHARD_REPEATS}, "repeat launches", cnt)
    log(f"phase 7: {RAGGED_DOCS} documents ({len(pk.data)} bytes packed) "
        f"at {list(SHARD_COUNTS)} shards, strict and replace, and the "
        f"sharded scan: each = unsharded, launches per call {per_call}; "
        f"{SHARD_REPEATS} more calls at 8 shards, each = unsharded")
    report["full_width"] = {"docs": RAGGED_DOCS,
                            "packed_bytes": int(len(pk.data)),
                            "launches_per_call": per_call,
                            "repeats_at_8": SHARD_REPEATS}

    if cuda:
        from torch.profiler import ProfilerActivity, profile
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sharded(*args, 8, errors="replace")
            sync()
        trace = out_dir / "shard_profile.json"
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))
        kern = [e for e in json.loads(trace.read_text())["traceEvents"]
                if e.get("cat") == "kernel"
                and "ronepass" in e.get("name", "")]
        streams = sorted({e.get("args", {}).get("stream") for e in kern})
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kern)
        overlap = any(b0 < a1 for (_a0, a1), (b0, _b1)
                      in zip(spans, spans[1:]))
        report["profile"] = {"ronepass_launches": len(kern),
                             "streams": streams, "overlapped": overlap,
                             "spans_us": spans}
        log(f"phase 7: profiler, one 8-shard call: {len(kern)} ronepass "
            f"launches on {len(streams)} streams {streams}; launches "
            f"overlapped: {overlap}")
        require(not kern or (len(kern) == 8 and len(streams) == 8),
                "8 launches on 8 streams", len(kern), streams)

    # Split documents: the 64 MiB buffer among three small documents.
    split_docs = [docs[1], big, docs[2], docs[3]]
    spk = packing.pack_documents(split_docs)
    n_tiles = len(big) // BLOCK
    tiles = np.sort(rng.choice(np.arange(1, n_tiles - 1), 64,
                               replace=False))
    bad = spk.data.copy()
    lo = int(spk.offsets[1])
    bad[lo: lo + len(big)] = inject(big, "utf8", tiles)
    bad_docs = list(split_docs)
    bad_docs[1] = bad[lo: lo + len(big)]
    plan = shard.plan_shards(*spk, 4)
    require(int((plan.frag_doc == 1).sum()) == 4, "64 MiB document split "
            "over the 4 shards", plan.frag_doc.tolist())
    split = {}
    for name, data, dd in (("valid", spk.data, split_docs),
                           ("invalid", bad, bad_docs)):
        for errors in ("strict", "replace"):
            w = unsharded(data, spk.offsets, spk.lengths, errors=errors)
            g, cnt = counted(lambda: sharded(data, spk.offsets, spk.lengths,
                                             4, errors=errors))
            require(cnt == {"ronepass": 4}, "split launches", cnt)
            if name == "invalid" and errors == "strict":
                split[f"{name} {errors}"] = hold_split(
                    w, g, plan, dd, name, errors)
                require(split[f"{name} {errors}"] == [1], "strict caveat",
                        split)
            else:
                same(w, g, "split", name, errors)
                split[f"{name} {errors}"] = []
    report["split"] = {"bytes": int(len(big)), "cuts_inside": [
        int(b) for b in plan.frag_base[plan.frag_doc == 1]],
        "relaxed_docs": split}
    log(f"phase 7: a {len(big)}-byte document among 3 small ones at 4 "
        f"shards, cut inside at {report['split']['cuts_inside']}: valid "
        f"(both policies) and 64 invalid units at tile starts (replace) = "
        f"unsharded; strict = unsharded but past the split document's "
        f"first error")

    # The other cells at 4 shards.
    cells = {}
    for src in ("utf16", "utf32", "latin1"):
        cdocs = cell_docs(src, text_cps, rng)
        cpk = packing.pack_documents(cdocs, dtype=NP_DTYPE[src])
        for errors in ("strict", "replace"):
            w = unsharded(*cpk, src_format=src, dst_format="utf8",
                          errors=errors)
            g, cnt = counted(lambda: sharded(
                *cpk, 4, src_format=src, dst_format="utf8", errors=errors))
            require(cnt == {"ronepass": 4}, "cell launches", src, cnt)
            same(w, g, src, errors)
        cells[src] = {"docs": len(cdocs), "packed": int(len(cpk.data)),
                      "invalid_docs": int((w.statuses >= 0).sum())}
    report["cells"] = cells
    log(f"phase 7: utf16, utf32, latin1 -> utf8 at 4 shards, both "
        f"policies = unsharded ({cells})")

    # Supervision: the reference's replan, at full width.
    pol = recovery.RetryPolicy(max_retries=1, backoff_base_s=0.0)
    sup_log = recovery.SupervisionLog()
    with faults.harness(faults.Fault(faults.SHARD_LAUNCH,
                                     times=(1, 2, 3, 4))) as h:
        res, cnt = counted(lambda: recovery.supervised_ragged_transcode(
            *args, mesh=meshes[8], policy=pol, log=sup_log))
    require(h.calls == {faults.SHARD_LAUNCH: 5} and sup_log.replans == 2
            and sup_log.final_shards == 6 and sup_log.retries == 2,
            "replan", h.calls, sup_log)
    require(cnt == {"ronepass": 6}, "replan launches", cnt)
    same(want["strict"], res, "replan")
    # A hang past the watchdog, then a retried success (the UTF-16 cell).
    hang_log = recovery.SupervisionLog()
    cpk = packing.pack_documents(cell_docs("utf16", text_cps, rng),
                                 dtype=np.uint16)
    w = unsharded(*cpk, src_format="utf16", dst_format="utf8")
    t0 = time.perf_counter()
    with faults.harness(faults.Fault(faults.SHARD_LAUNCH, kind="hang",
                                     hang_s=SHARD_HANG_S, times=(1,))):
        res = recovery.supervised_ragged_transcode(
            *cpk, src_format="utf16", dst_format="utf8", mesh=meshes[4],
            log=hang_log, policy=recovery.RetryPolicy(
                backoff_base_s=0.0, watchdog_s=SHARD_WATCHDOG_S,
                poll_s=0.002))
    hang_s = time.perf_counter() - t0
    require(hang_log.attempts == [(4, 0, "WatchdogTimeout"), (4, 1, "ok")]
            and hang_s < SHARD_HANG_S, "hang", hang_log, hang_s)
    same(w, res, "hang retry")
    for t in threading.enumerate():     # the abandoned attempt
        if t.name.startswith("watchdog:"):
            t.join(60.0)
    sync()
    report["supervision"] = {
        "replan": {"calls": h.calls[faults.SHARD_LAUNCH],
                   "attempts": sup_log.attempts, "launches": cnt},
        "hang": {"attempts": hang_log.attempts, "seconds": hang_s}}
    log(f"phase 7: replan 8 -> 7 -> 6 at full width: attempts "
        f"{sup_log.attempts}, {cnt} = unsharded; hang past a "
        f"{SHARD_WATCHDOG_S} s watchdog: {hang_log.attempts} in "
        f"{hang_s:.2f} s = unsharded")

    # The feeder: the batch in waves of 4 shards.
    q = -(-len(docs) // SHARD_WAVES)
    wave_pk = [packing.pack_documents(docs[k * q: (k + 1) * q])
               for k in range(SHARD_WAVES)]
    plans = [shard.plan_shards(*p, 4) for p in wave_pk]
    wave_want = [unsharded(*p) for p in wave_pk]
    (outs, stats), cnt = counted(lambda: shard_feed.run_sharded_waves(
        meshes[4], plans, src="utf8", dst="utf16"))
    require(cnt == {"ronepass": 4 * SHARD_WAVES}, "feeder launches", cnt)

    def gather(k, out):
        return shard._gather_result(plans[k], len(wave_pk[k].data),
                                    torch.uint16, *out, True)

    for k, out in enumerate(outs):
        same(wave_want[k], gather(k, out), "feeder wave", k)
    hidden = shard_feed.hidden_fraction(stats)
    with faults.harness(faults.Fault(faults.FEED_STAGE, times=(2,))) as h:
        (outs2, _st), cnt2 = counted(lambda: shard_feed.run_sharded_waves(
            meshes[4], plans, src="utf8", dst="utf16"))
    require(h.calls == {faults.FEED_STAGE: SHARD_WAVES}
            and isinstance(outs2[1], shard_feed.WaveFailure)
            and outs2[1].phase == "stage"
            and cnt2 == {"ronepass": 4 * (SHARD_WAVES - 1)},
            "feed.stage fault", h.calls, outs2[1], cnt2)
    for k, out in enumerate(outs2):
        if k != 1:
            same(wave_want[k], gather(k, out), "feeder wave after fault", k)
    report["feeder"] = {"waves": SHARD_WAVES, "shards": 4,
                        "stats_s": [list(s) for s in stats],
                        "hidden_fraction": hidden}
    log(f"phase 7: feeder, {SHARD_WAVES} waves of 4 shards, each = "
        f"unsharded; [transfer_s, compute_s, stall_s] a wave "
        f"{[[round(v, 5) for v in s] for s in stats]}, hidden fraction "
        f"{hidden:.3f}; feed.stage fault at wave 1: a stage WaveFailure, "
        f"waves 0, 2, 3 = unsharded  [{smi}]")

    # The engine, its ingress sharded over 4 slots.
    eng = E.Engine(model, model.cfg, "lm", model, device=dev,
                   ingress_shards=4)
    tokens = {}
    finish = eng._finish_slot

    def finish_slot(slots, j):
        tokens[slots[j].ticket] = list(slots[j].tokens)
        finish(slots, j)

    eng._finish_slot = finish_slot
    ingress_ms, ingress_fn = [], eng._ingress_chunk

    def timed_ingress(group, bound, take):
        t0 = time.perf_counter()
        out = ingress_fn(group, bound, take)
        ingress_ms.append([eng._group_name(group), bound, len(take),
                           (time.perf_counter() - t0) * 1e3])
        return out

    eng._ingress_chunk = timed_ingress
    tickets = [eng.submit(E.Request(**kw)) for kw, _t in served["specs"]]
    with faults.harness() as h:
        t0 = time.perf_counter()
        _out, cnt = counted(eng.drain)
        wall_ms = (time.perf_counter() - t0) * 1e3
    mine = served_by(served["specs"], [eng.poll(t) for t in tickets],
                     tokens)
    require(mine["results"] == served["results"], "sharded engine results",
            mine["results"], served["results"])
    require(mine["tokens"] == served["tokens"], "sharded engine tokens")
    chunks = (h.calls.get(faults.KERNEL_RAGGED_SCAN, 0),
              h.calls.get(faults.KERNEL_RAGGED, 0))
    want_cnt = {"rcount": 4 * chunks[0], "ronepass": 4 * chunks[1],
                "onepass": h.calls.get(faults.KERNEL_ONEPASS, 0)}
    require(all(chunks) and cnt == {k: v for k, v in want_cnt.items() if v}
            and h.calls.get(faults.SHARD_LAUNCH) == sum(chunks),
            "sharded engine launches", cnt, h.calls)
    report["engine"] = {"ingress_shards": 4, "launches": cnt,
                        "fault_hook_calls": dict(h.calls),
                        "counters": dict(eng.counters), "wall_ms": wall_ms,
                        "ingress_ms": ingress_ms}
    log(f"phase 7: Engine(ingress_shards=4) served phase 6's "
        f"{len(tickets)} requests in {wall_ms:.1f} ms = the unsharded "
        f"engine (codes, offsets, sanitized prompts, egress bytes, "
        f"tokens); launches {cnt}, fault-hook calls {dict(h.calls)}; "
        f"ingress [group, bucket, prompts, ms] {ingress_ms}  [{smi}]")
    del eng
    if cuda:
        report["times"] = shard_times(meshes, pk, x, want, want_scan, smi)
    return report, launches


def shard_times(meshes, pk, x, want, want_scan, smi: str) -> dict:
    """Phase 7's times on the card: at each of ``SHARD_COUNTS``, the
    sharded call and the sharded scan of phase 3's batch, whole (host
    clock, synchronised) and split: the plan (host: layout checks and
    ``plan_shards``), pinning the plan's rows (host), the copy in, the
    kernels (ownership, kernel, per-fragment reduce and stack on the
    shards' streams) and the gather, the last three between CUDA events
    on the caller's stream (each median of ``SHARD_TIME_REPS`` after a
    warm-up); each shard's kernel alone (:func:`device_ms`); and the
    unsharded calls (:func:`cuda_ms`)."""
    import torch
    import repro_torch
    from repro_torch.core import shard
    from repro_torch.kernels import ragged_transcode as rt

    args = (pk.data, pk.offsets, pk.lengths)
    out = {"unsharded": {
        "ragged_transcode ms": cuda_ms(lambda: repro_torch.ragged_transcode(
            x, pk.offsets, pk.lengths), SHARD_TIME_REPS),
        "ragged_scan ms": cuda_ms(lambda: repro_torch.ragged_scan(
            x, pk.offsets, pk.lengths), SHARD_TIME_REPS)}}
    for scan in (False, True):
        kind = "scan" if scan else "transcode"
        for n, mesh in meshes.items():
            parts = {k: [] for k in ("plan", "pin", "copy", "kernels",
                                     "gather", "split_total", "whole")}
            for r in range(SHARD_TIME_REPS + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _m, plan, length, _cd, _f = shard._plan(
                    *args, "utf8", "utf16", None, mesh, None, None, kind)
                t1 = time.perf_counter()
                rows = [t.pin_memory() for t in shard.plan_rows(plan)]
                t2 = time.perf_counter()
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(4)]
                ev[0].record()
                rows = [t.to(x.device, non_blocking=True) for t in rows]
                ev[1].record()
                if scan:
                    outs = shard.sharded_scan_call(mesh, "utf8",
                                                   "utf16")(*rows)
                    ev[2].record()
                    res = shard._doc_counts_statuses(plan, *outs, True)
                else:
                    outs = shard.sharded_call(mesh, "utf8", "utf16", True,
                                              "strict")(*rows)
                    ev[2].record()
                    res = shard._gather_result(plan, length, torch.uint16,
                                               *outs, True)
                ev[3].record()
                ev[3].synchronize()
                t3 = time.perf_counter()
                ref = want_scan if scan else want["strict"]
                require(all(equal(a, b) for a, b in zip(ref, res)),
                        "timed split", kind, n)
                torch.cuda.synchronize()
                t4 = time.perf_counter()
                if scan:
                    shard.scan_ragged_sharded(*args, mesh=mesh)
                else:
                    repro_torch.ragged_transcode(
                        *args, strategy="sharded", shard_mesh=mesh)
                torch.cuda.synchronize()
                t5 = time.perf_counter()
                if r == 0:
                    continue                      # warm-up
                for k, v in (("plan", (t1 - t0) * 1e3),
                             ("pin", (t2 - t1) * 1e3),
                             ("copy", ev[0].elapsed_time(ev[1])),
                             ("kernels", ev[1].elapsed_time(ev[2])),
                             ("gather", ev[2].elapsed_time(ev[3])),
                             ("split_total", (t3 - t0) * 1e3),
                             ("whole", (t5 - t4) * 1e3)):
                    parts[k].append(v)
            # Each shard's kernel alone, device time.
            x_rows = rows[0]
            alone = []
            for k in range(n):
                xk, off = x_rows[k], rows[1][k]
                own = shard._ownership(xk, off, rows[2][k])
                if scan:
                    alone.append(device_ms(lambda: rt.rcount_kernel(
                        xk, own, src="utf8", dst="utf16", errors="strict",
                        validate=True), SHARD_TIME_REPS))
                else:
                    cap = own[0].shape[0] * BLOCK
                    alone.append(device_ms(lambda: rt.ronepass_kernel(
                        xk, own, cap, src="utf8", dst="utf16",
                        errors="strict", validate=True), SHARD_TIME_REPS))
            t = {f"{k} ms": statistics.median(v) for k, v in parts.items()}
            t["per-shard kernel device ms"] = alone
            out[f"{kind} n={n}"] = t
            log(f"phase 7: sharded {kind} n={n}: whole {t['whole ms']:.3f} "
                f"ms; plan {t['plan ms']:.3f} (host), pin {t['pin ms']:.3f} "
                f"(host), copy in {t['copy ms']:.3f}, kernels "
                f"{t['kernels ms']:.3f}, gather {t['gather ms']:.3f} ms; "
                f"each shard's kernel alone (device ms) "
                f"{[round(a, 4) for a in alone]}  [{smi}]")
    u = out["unsharded"]
    log(f"phase 7: unsharded ragged_transcode "
        f"{u['ragged_transcode ms']:.4f} ms, ragged_scan "
        f"{u['ragged_scan ms']:.4f} ms a call  [{smi}]")
    return out


# ---------------------------------------------------------------------------
# Phase 8: training.


def _clock(fn, cuda: bool):
    """``(fn(), ms)``: host clock around ``fn`` and a synchronise."""
    import torch
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _train_batch(rng, vocab: int, b: int, s: int, device):
    """Byte tokens and labels (B, S) from ``rng``; the last row's last
    quarter of labels is padding (-1)."""
    import torch
    toks = rng.integers(3, vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[-1, -(s // 4):] = -1
    return {"tokens": torch.from_numpy(toks).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def train_flops(cfg, batch: int, seq: int) -> dict:
    """Operations of one training step of a dense decoder with full remat,
    and its least times.  The forward: :func:`dense_products`, the
    unembedding included, and 4 * head_dim per live (causal, windowed)
    pair and head; the recompute: the layers again (the unembedding is
    outside the checkpointed layers); the backward: twice the forward.
    ``products`` is the step's product FLOPs outside attention.
    ``bound_bf16_ms`` takes all of it at the bf16 peak; ``bound_ms``
    takes the backward as float32 products at the float32 rate (the
    products' gradient is float32: ``models.common._Mm32``)."""
    p = dense_products(cfg, batch * seq)
    attention = (4 * cfg.hd * cfg.n_heads * cfg.n_layers * batch
                 * live_pairs(seq, cfg.window))
    forward = p["layers"] + p["unembed"] + attention
    recompute = p["layers"] + attention
    step = forward + recompute + 2 * forward
    return {"forward_flops": forward, "recompute_flops": recompute,
            "step_flops": step,
            "products": 4 * p["layers"] + 3 * p["unembed"],
            "attention": 4 * attention,
            "bound_bf16_ms": step / roofline.BF16_FLOPS * 1e3,
            "bound_ms": ((forward + recompute) / roofline.BF16_FLOPS
                         + 2 * forward / roofline.F32_FLOPS) * 1e3}


def train_phase(rng, smi: str, zero_counts, read_counts, work: Path,
                device="cuda", danube_cfg=None) -> tuple:
    """Phase 8, training (``repro_torch.train``, ``launch/train.py``),
    after phase 7 frees qwen3-8b.  ``work`` holds the checkpoints (a
    temporary directory; they are ~0.85 GB each at full width).

      (a) bytelm-100m reduced, float32, TF32 off: the same weights (one
          generator) on the card and on the CPU, 3 steps of the same
          batches; loss, ``grad_norm``, ``lr`` and every parameter after
          each step within ``TRAIN_F32_TOL``, the CPU tests' tolerance.
      (b) bytelm-100m at its published config (bf16): one step at
          ``TRAIN_BF16_BATCH`` on the card (the products' backward
          through ``models.common``'s ``autograd.Function``) and on the
          host's CPU from the same weights, within ``TRAIN_BF16_TOL``.
      (c) The launcher in process (``launch.train.main``) at full width,
          ``--batch 8 --seq 512``: run A, 20 steps with a checkpoint
          every 10; run B, 10 steps then ``--steps 20 --resume``.  The
          step-10 state restores bit-equal to what was saved; B's
          batches of steps 11-20 equal A's; B's final parameters are
          within ``TRAIN_RESUME_REL`` of A's; A's loss falls.  A
          subprocess gets SIGTERM after its first log line: exit 0, the
          message, one ``step_N``.
      (d) One step with ``remat`` off, ``"full"`` and ``"dots"``: loss
          equal, ``grad_norm`` within ``TRAIN_REMAT_REL``; peak memory
          and step time each.
      (e) h2o-danube-1.8b at full width (``danube_cfg`` shrinks it for a
          rehearsal), 1 x 4096, remat ``"full"``: 3 steps on one batch
          at the launcher's learning rate; loss and ``grad_norm``
          finite, the loss not rising; peak memory.
      (f) ``launch.serve.main --ckpt-dir`` on run A's checkpoint, the
          launch counts set to 0 just before and read just after: it
          loads step 20 and every response is ``ok=True``.
      Times (card only): a step split into ``next_batch``, forward,
      backward and optimizer, tokens/s, device busy ms and launches a
      step (``torch.profiler``), peak memory, checkpoint save and
      restore ms and bytes.

    Returns ``(report, launches)``."""
    import contextlib
    import io
    import os
    import signal as signal_mod

    import torch
    from repro_torch import configs
    from repro_torch.data import pipeline as pipemod
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import registry, weights
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    report = {}

    def peak_reset():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() if cuda else None

    # (a) reduced, float32, TF32 off: card = CPU over 3 steps.
    torch.backends.cuda.matmul.allow_tf32 = False
    fam, cfg_r, host = registry.get(
        TRAIN_ARCH, reduced=True, device="cpu",
        generator=torch.Generator().manual_seed(int(rng.integers(2**31))))
    card = registry.build(cfg_r, device=dev)
    card.load_state_dict(host.state_dict())
    opt_cfg = O.AdamWConfig(lr=3e-4, total_steps=20, warmup_steps=5)
    steps = (TS.make_train_step(host, fam, opt_cfg),
             TS.make_train_step(card, fam, opt_cfg))
    f32_err = {"metrics": 0.0, "params": 0.0}
    for k in range(3):
        b_np = _train_batch(rng, cfg_r.vocab, 4, 64, "cpu")
        mh = steps[0](b_np)
        mc = steps[1]({n: v.to(dev) for n, v in b_np.items()})
        for key in ("loss", "grad_norm", "lr"):
            g, w = float(mc[key]), float(mh[key])
            f32_err["metrics"] = max(f32_err["metrics"], abs(g - w))
            require(abs(g - w) <= TRAIN_F32_TOL["atol"]
                    + TRAIN_F32_TOL["rtol"] * abs(w), "train f32 card vs "
                    "cpu", key, k, g, w)
        hp = dict(host.named_parameters())
        for n, p in card.named_parameters():
            g, w = p.detach().cpu(), hp[n].detach()
            f32_err["params"] = max(f32_err["params"],
                                    float((g - w).abs().max()))
            require(torch.allclose(g, w, **TRAIN_F32_TOL), "train f32 "
                    "params card vs cpu", n, k, float((g - w).abs().max()))
    report["f32_card_vs_cpu_max_abs"] = f32_err
    log(f"phase 8: {TRAIN_ARCH} reduced f32 (TF32 off), 3 steps card = cpu "
        f"within atol {TRAIN_F32_TOL['atol']:g} rtol "
        f"{TRAIN_F32_TOL['rtol']:g}: loss, grad_norm, lr max abs err "
        f"{f32_err['metrics']:.3g}, parameters {f32_err['params']:.3g}")
    del host, card, steps

    # (b) full width, bf16, one step: card vs the host's CPU.
    cfg = configs.get_config(TRAIN_ARCH)
    seed = int(rng.integers(2**31))
    host = registry.build(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(seed))
    card = registry.build(cfg, device=dev)
    card.load_state_dict(host.state_dict())
    b_np = _train_batch(rng, cfg.vocab, *TRAIN_BF16_BATCH, "cpu")
    bf_cfg = O.AdamWConfig(lr=3e-4, total_steps=20, warmup_steps=5)
    (mh, host_ms) = _clock(lambda: TS.make_train_step(host, fam, bf_cfg)(
        b_np), False)
    mc = TS.make_train_step(card, fam, bf_cfg)(
        {n: v.to(dev) for n, v in b_np.items()})
    bf = {k: (float(mc[k]), float(mh[k])) for k in ("loss", "grad_norm",
                                                    "lr")}
    lr1 = bf["lr"][1]
    hp = dict(host.named_parameters())
    excess = 0.0
    for n, p in card.named_parameters():
        g, w = p.detach().float().cpu(), hp[n].detach().float()
        bound = 2 * lr1 + TRAIN_BF16_TOL["param_rel"] * w.abs()
        excess = max(excess, float(((g - w).abs() - bound).max()))
    bf_report = {k: {"card": g, "cpu": w, "rel": abs(g - w) / abs(w)}
                 for k, (g, w) in bf.items()}
    bf_report["param_excess_over_bound"] = excess
    bf_report["cpu_step_ms"] = host_ms
    report["bf16_card_vs_cpu"] = bf_report
    log(f"phase 8: {TRAIN_ARCH} full width bf16, one step "
        f"{TRAIN_BF16_BATCH[0]} x {TRAIN_BF16_BATCH[1]} card vs cpu: loss "
        f"{bf['loss'][0]:.6f} / {bf['loss'][1]:.6f} (rel "
        f"{bf_report['loss']['rel']:.3g}), grad_norm {bf['grad_norm'][0]:.5f}"
        f" / {bf['grad_norm'][1]:.5f} (rel "
        f"{bf_report['grad_norm']['rel']:.3g}); parameters within 2 lr + "
        f"{TRAIN_BF16_TOL['param_rel']:g} |p| (largest excess {excess:.3g}); "
        f"cpu step {host_ms:.0f} ms")
    require(bf["lr"][0] == bf["lr"][1], "bf16 lr", bf["lr"])
    require(bf_report["loss"]["rel"] <= TRAIN_BF16_TOL["loss_rel"],
            "bf16 loss card vs cpu", bf["loss"])
    require(bf_report["grad_norm"]["rel"] <= TRAIN_BF16_TOL["gnorm_rel"],
            "bf16 grad_norm card vs cpu", bf["grad_norm"])
    require(excess <= 0, "bf16 parameters card vs cpu", excess)
    del host, card

    # (c) the launcher at full width, in process.
    saved, batches = {}, {}
    real_save, real_next = CK.save, pipemod.TextPipeline.next_batch

    def recording_save(ckpt_dir, step, tree, *a, **kw):
        saved[(str(ckpt_dir), step)] = tree
        return real_save(ckpt_dir, step, tree, *a, **kw)

    def recording_next(self):
        step = self.step
        batch = real_next(self)
        batches.setdefault(run, {})[step] = batch["tokens"].cpu()
        return batch

    def launch(name, *extra):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            launch_train.main(["--arch", TRAIN_ARCH, "--batch",
                               str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                               "--device", str(dev.type), "--ckpt-dir",
                               str(work / name), *extra])
        return out.getvalue()

    CK.save, pipemod.TextPipeline.next_batch = recording_save, recording_next
    try:
        run = "A"
        out_a, a_ms = _clock(lambda: launch(
            "a", "--steps", str(TRAIN_STEPS), "--ckpt-every",
            str(TRAIN_CKPT_EVERY), "--log-every", "1"), cuda)
        run = "B1"
        launch("b", "--steps", str(TRAIN_CKPT_EVERY), "--ckpt-every",
               str(TRAIN_CKPT_EVERY))
        run = "B2"
        out_b2 = launch("b", "--steps", str(TRAIN_STEPS), "--ckpt-every",
                        str(TRAIN_CKPT_EVERY), "--resume")
    finally:
        CK.save, pipemod.TextPipeline.next_batch = real_save, real_next
    losses_a = [float(ln.split()[3]) for ln in out_a.splitlines()
                if ln.startswith("step ")]
    require(len(losses_a) == TRAIN_STEPS, "run A log lines", out_a[-500:])
    require(losses_a[-1] < losses_a[0], "run A loss falls", losses_a)
    require("resumed from step 10" in out_b2, "run B resumed", out_b2)
    for s in range(TRAIN_CKPT_EVERY, TRAIN_STEPS):
        require(torch.equal(batches["B2"][s], batches["A"][s]),
                "resumed batch vs run A", s)
    require(sorted(batches["B2"]) == list(range(TRAIN_CKPT_EVERY,
                                                  TRAIN_STEPS)),
            "run B's steps after resume", sorted(batches["B2"]))
    # the step-10 state restores bit-equal to what run A saved
    _, _, model = registry.get(TRAIN_ARCH, device=dev)
    state = O.init_opt_state(model)
    like = launch_train.state_like(model)
    launch_train.load_state(model, state, CK.restore(
        str(work / "a"), TRAIN_CKPT_EVERY, like))
    back = launch_train.state_tree(model, state)
    want = saved[(str(work / "a"), TRAIN_CKPT_EVERY)]

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v
    got_leaves = dict(leaves(back))
    for name, w in leaves(want):
        require(got_leaves[name].dtype == w.dtype
                and torch.equal(got_leaves[name], w),
                "step-10 restore vs saved", name)
    # B's final parameters against A's, relative to how far A moved
    fin = {r: CK.restore(str(work / r), TRAIN_STEPS, like)["params"]
           for r in ("a", "b")}
    init = weights.to_reference(
        registry.get(TRAIN_ARCH, device=dev)[2])
    a_l, b_l, i_l = (dict(leaves(t)) for t in (fin["a"], fin["b"], init))
    diff = sum(float((b_l[n].float() - a_l[n].float()).norm()) ** 2
               for n in a_l) ** 0.5
    moved = sum(float((a_l[n].float() - i_l[n].float()).norm()) ** 2
                for n in a_l) ** 0.5
    resume_rel = diff / moved
    del model, state, back, want, saved, fin, init, a_l, b_l, i_l
    require(resume_rel <= TRAIN_RESUME_REL, "run B vs run A parameters",
            resume_rel)

    # SIGTERM after the first log line, in a process of its own.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
         "--steps", "100000", "--log-every", "1", "--ckpt-every", "100000",
         "--device", str(dev.type), "--ckpt-dir", str(work / "sigterm")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT))
    try:
        for line in proc.stdout:
            if line.startswith("step "):
                proc.send_signal(signal_mod.SIGTERM)
                break
        term_out, term_err = proc.communicate(timeout=300)
    finally:
        proc.kill()
        proc.wait()
    term_dirs = sorted(os.listdir(work / "sigterm"))
    require(proc.returncode == 0 and "SIGTERM: checkpointed, exiting"
            in term_out and len(term_dirs) == 1
            and term_dirs[0].startswith("step_")
            and not term_dirs[0].endswith(".tmp"), "SIGTERM run",
            proc.returncode, term_out[-300:], term_err[-1500:], term_dirs)
    report["launcher"] = {
        "run_a_losses": losses_a, "run_a_ms": a_ms,
        "run_a_log": out_a.splitlines()[-3:], "run_b_log":
        out_b2.splitlines(), "resume_rel_l2": resume_rel,
        "sigterm_checkpoint": term_dirs[0]}
    log(f"phase 8: launcher {TRAIN_ARCH} full width, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}: run A {TRAIN_STEPS} steps in {a_ms:.0f} ms, loss "
        f"{losses_a[0]:.4f} -> {losses_a[-1]:.4f}; run B resumed at "
        f"{TRAIN_CKPT_EVERY}, its batches = A's, the step-"
        f"{TRAIN_CKPT_EVERY} restore bit-equal, |B - A| / |A - init| "
        f"{resume_rel:.4f} (<= {TRAIN_RESUME_REL}); SIGTERM: exit 0, "
        f"{term_dirs[0]}")

    # The step's times at full width: split, whole, profiler, memory,
    # checkpoint save and restore.
    _, _, model = registry.get(TRAIN_ARCH, device=dev)
    cfg = model.cfg
    opt_cfg = O.AdamWConfig(lr=3e-4, total_steps=100, warmup_steps=5)
    step_fn = TS.make_train_step(model, fam, opt_cfg)
    loss_fn = TS.make_loss_fn(model, fam)
    params = dict(model.named_parameters())
    decay = weights.decay_mask(model)
    pipe = pipemod.TextPipeline(pipemod.PipelineConfig(
        seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH), device=dev)
    split = {k: [] for k in ("next_batch", "forward", "backward",
                             "optimizer", "step")}
    for i in range(TRAIN_WARMUP + TRAIN_REPS):
        batch, t_nb = _clock(pipe.next_batch, cuda)
        (loss, _m), t_fw = _clock(lambda: loss_fn(batch), cuda)
        _, t_bw = _clock(loss.backward, cuda)
        _, t_opt = _clock(lambda: O.adamw_update(
            opt_cfg, params, {n: p.grad for n, p in params.items()},
            step_fn.opt_state, decay), cuda)
        model.zero_grad(set_to_none=True)
        peak_reset()
        before = torch.cuda.memory_allocated() if cuda else None
        _, t_step = _clock(lambda: step_fn(batch), cuda)
        if i >= TRAIN_WARMUP:
            for k, v in zip(split, (t_nb, t_fw, t_bw, t_opt, t_step)):
                split[k].append(v)
    step_peak = peak()
    times = {f"{k}_ms": statistics.median(v) for k, v in split.items()}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    times["tokens_per_s"] = tokens / ((times["step_ms"]
                                       + times["next_batch_ms"]) / 1e3)
    times["peak_memory_bytes"] = step_peak
    times["memory_before_bytes"] = before
    times["busy"] = device_busy(lambda: step_fn(batch)) if cuda else None
    _, times["checkpoint_save_ms"] = _clock(lambda: CK.save(
        str(work / "timed"), 1, launch_train.state_tree(
            model, step_fn.opt_state)), cuda)
    times["checkpoint_bytes"] = sum(
        f.stat().st_size for f in (work / "timed" / "step_1").iterdir())
    _, times["checkpoint_restore_ms"] = _clock(
        lambda: launch_train.load_state(model, step_fn.opt_state, CK.restore(
            str(work / "timed"), 1, launch_train.state_like(model))), cuda)
    n_params = model.param_count()
    times["params"] = n_params
    times.update(train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ))
    report["step"] = times
    busy = times["busy"] or {}
    log(f"phase 8: {TRAIN_ARCH} step ({TRAIN_BATCH} x {TRAIN_SEQ}, remat "
        f"{cfg.remat_policy if cfg.remat else 'off'}, median of "
        f"{TRAIN_REPS}): {times['step_ms']:.2f} ms (+ next_batch "
        f"{times['next_batch_ms']:.2f}); split forward "
        f"{times['forward_ms']:.2f}, backward {times['backward_ms']:.2f}, "
        f"optimizer {times['optimizer_ms']:.2f} ms; "
        f"{times['tokens_per_s']:,.0f} tokens/s; device busy "
        f"{busy.get('busy_ms')} ms in {busy.get('launches')} launches; bound "
        f"{times['bound_ms']:.2f} ms ({times['step_flops'] / 1e12:.2f} TFLOP,"
        f" the backward in f32; all bf16 {times['bound_bf16_ms']:.2f}); "
        f"peak {step_peak} B ({before} B held before the step); checkpoint "
        f"save {times['checkpoint_save_ms']:.0f} "
        f"ms, restore {times['checkpoint_restore_ms']:.0f} ms, "
        f"{times['checkpoint_bytes']} B  [{smi}]")
    if busy:
        log("phase 8: step on the device, most time: " + "; ".join(
            f"{k} {ms:.3f} ms x{n}" for k, ms, n in busy["top"]))
    del model, step_fn, loss_fn, params, pipe, batch, loss

    # (d) remat off, "full" and "dots": one step each from one set of
    # weights on one batch, then TRAIN_REPS timed steps.
    remat = {}
    batch = _train_batch(rng, cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, dev)
    seed = int(rng.integers(2**31))
    for label, kw in (("off", dict(remat=False)),
                      ("full", dict(remat=True, remat_policy="full")),
                      ("dots", dict(remat=True, remat_policy="dots"))):
        m = registry.build(dataclasses.replace(cfg, **kw), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(seed))
        st = TS.make_train_step(m, fam, opt_cfg)
        peak_reset()
        first = st(batch)
        ms = [_clock(lambda: st(batch), cuda)[1] for _ in range(TRAIN_REPS)]
        remat[label] = {"loss": float(first["loss"]),
                        "grad_norm": float(first["grad_norm"]),
                        "step_ms": statistics.median(ms),
                        "peak_memory_bytes": peak()}
        del m, st
    for label in ("full", "dots"):
        r, o = remat[label], remat["off"]
        require(r["loss"] == o["loss"], "remat loss", label, r["loss"],
                o["loss"])
        require(abs(r["grad_norm"] - o["grad_norm"])
                <= TRAIN_REMAT_REL * o["grad_norm"], "remat grad_norm",
                label, r["grad_norm"], o["grad_norm"])
    report["remat"] = remat
    log(f"phase 8: remat ({TRAIN_ARCH}, {TRAIN_BATCH} x {TRAIN_SEQ}): " +
        "; ".join(f"{k}: loss {v['loss']:.6f} grad_norm "
                  f"{v['grad_norm']:.6f} step {v['step_ms']:.2f} ms peak "
                  f"{v['peak_memory_bytes']} B" for k, v in remat.items())
        + f"  [{smi}]")

    # (e) h2o-danube-1.8b at full width, remat "full", 3 steps.
    dcfg = danube_cfg or configs.get_config(DANUBE_ARCH)
    dcfg = dataclasses.replace(dcfg, remat=True, remat_policy="full")
    peak_reset()
    d_seed = int(rng.integers(2**31))
    model = registry.build(dcfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(d_seed))
    d_cfg = O.AdamWConfig(lr=3e-4, total_steps=DANUBE_STEPS,
                          warmup_steps=max(DANUBE_STEPS // 20, 5))
    st = TS.make_train_step(model, "lm", d_cfg)
    dpipe = pipemod.TextPipeline(pipemod.PipelineConfig(
        seq_len=DANUBE_SEQ, global_batch=1), device=dev)
    dbatch = dpipe.next_batch()
    d_runs = []
    for _ in range(DANUBE_STEPS):
        met, ms = _clock(lambda: st(dbatch), cuda)
        d_runs.append({"loss": float(met["loss"]),
                       "grad_norm": float(met["grad_norm"]),
                       "lr": float(met["lr"]), "ms": ms})
    d_peak = peak()
    d_params = model.param_count()
    # one more step under the profiler, after the checked three
    d_busy = device_busy(lambda: st(dbatch)) if cuda else None
    del model, st
    if cuda:
        torch.cuda.empty_cache()
    d_losses = [r["loss"] for r in d_runs]
    require(all(np.isfinite([r["loss"] for r in d_runs]
                            + [r["grad_norm"] for r in d_runs])),
            "danube finite", d_runs)
    require(all(b <= a for a, b in zip(d_losses, d_losses[1:])),
            "danube loss does not rise", d_losses)
    report[DANUBE_ARCH] = {"steps": d_runs, "peak_memory_bytes": d_peak,
                           "params": d_params, "seq": DANUBE_SEQ,
                           "seed": d_seed, "busy": d_busy,
                           **train_flops(dcfg, 1, DANUBE_SEQ)}
    # phase 10's (1, 2) ranks take the same batch (not in the report)
    report["_danube_batch"] = {k: v.cpu() for k, v in dbatch.items()
                               if k in ("tokens", "labels")}
    log(f"phase 8: {DANUBE_ARCH} {dcfg.n_layers} layers d_model "
        f"{dcfg.d_model} ({d_params} parameters, bf16), 1 x {DANUBE_SEQ}, "
        f"remat full: losses {[round(x, 5) for x in d_losses]}, grad_norm "
        f"{[round(r['grad_norm'], 4) for r in d_runs]}, step ms "
        f"{[round(r['ms'], 1) for r in d_runs]}, bound "
        f"{report[DANUBE_ARCH]['bound_ms']:.1f} ms (all bf16 "
        f"{report[DANUBE_ARCH]['bound_bf16_ms']:.1f}), peak {d_peak} B  "
        f"[{smi}]")
    if d_busy:
        log(f"phase 8: {DANUBE_ARCH} step on the device: "
            f"{d_busy['launches']} launches, busy {d_busy['busy_ms']} ms; "
            "most time: " + "; ".join(f"{k} {ms:.3f} ms x{n}"
                                      for k, ms, n in d_busy["top"]))

    # (f) serve run A's checkpoint through the launcher.
    out = io.StringIO()
    if cuda:
        torch.cuda.synchronize()
    zero_counts()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--arch", TRAIN_ARCH, "--ckpt-dir",
                           str(work / "a"), "--device", str(dev.type)])
    launches = read_counts()
    lines = out.getvalue().splitlines()
    require(lines[0] == f"loaded checkpoint step {TRAIN_STEPS}",
            "served checkpoint", lines[:1])
    require(len(lines) == 5 and all(" ok=True " in ln for ln in lines[1:]),
            "served responses", lines)
    require(launches.get("rcount", 0) >= 1, "serve launches", launches)
    report["serve"] = {"lines": lines, "launches": launches}
    log(f"phase 8: launch.serve --ckpt-dir run A: {lines[0]}, "
        f"{len(lines) - 1} responses ok; launches {launches}")
    return report, launches


def analysis_phase(report: dict, smi: str, kernel_calls: dict,
                   table_bytes: dict, out_dir: Path) -> dict:
    """Phase 9, the analysis stack (``costmodel``, ``roofline``,
    ``launch/dryrun``), after phase 8.

      (a) The steps phases 5, 6 and 8 timed, costed on the meta device
          by ``dryrun.dryrun_cell`` at their shapes: qwen3-8b's prefill
          (phase 5's batch x bucket, its cache of bucket + new slots) and
          its decode step at the engine's batch and context (phase 6's
          graph step), bytelm-100m's and h2o-danube-1.8b's training
          steps (phase 8).  Each: FLOPs by class, bytes, the roofline's
          least time against the phase's measured time (``fraction`` =
          least / measured), and the predicted peak memory beside the
          measured one.  The products outside attention must equal
          :func:`dense_products`' closed forms (``model_bounds``,
          ``train_flops``) exactly, and attention must be at least the
          live pairs' products (the ratio printed).
      (b) Each transcode kernel of ``kernel_calls`` run on the card under
          ``CostMode``: its charge (operands + results, one launch)
          beside ``table_bytes``, the bytes behind its bound.
      (c) ``python -m repro_torch.launch.dryrun`` as a subprocess on
          qwen3-8b ``decode_32k``: exit 0 and a record that reads."""
    import torch
    from repro_torch import configs
    from repro_torch import costmodel as CM
    from repro_torch.launch import dryrun
    t0 = time.time()
    m, e, tr = (report["model"][MODEL_ARCH], report["engine"],
                report["train"])
    danube = tr[DANUBE_ARCH]
    steps = {
        "qwen3-8b prefill": (
            MODEL_ARCH, dict(kind="prefill", seq_len=m["bucket"],
                             global_batch=m["batch"], context=m["context"]),
            m["prefill_ms"], m["peak_memory_bytes"], None),
        "qwen3-8b decode graph step": (
            MODEL_ARCH, dict(kind="decode", seq_len=e["context"],
                             global_batch=e["max_batch"]),
            e["decode_ms"], e["peak_memory_bytes"], None),
        f"{TRAIN_ARCH} step": (
            TRAIN_ARCH, dict(kind="train", seq_len=TRAIN_SEQ,
                             global_batch=TRAIN_BATCH),
            tr["step"]["step_ms"], tr["step"]["peak_memory_bytes"],
            tr["step"]["memory_before_bytes"]),
        f"{DANUBE_ARCH} step": (
            DANUBE_ARCH, dict(kind="train", seq_len=DANUBE_SEQ,
                              global_batch=1),
            statistics.median(r["ms"] for r in danube["steps"]),
            danube["peak_memory_bytes"], None),
    }
    out = {"steps": {}, "kernels": {}}
    for label, (arch, shape, ms, peak, before) in steps.items():
        rec = dryrun.dryrun_cell(arch, label, shape=shape, verbose=False)
        cfg = configs.get_config(arch)
        b, s = shape["global_batch"], shape["seq_len"]
        ops = rec["flops_by_op"]
        if shape["kind"] == "train":
            want = train_flops(cfg, b, s)
            products, live = want["products"], want["attention"]
        else:
            p = dense_products(cfg, b * (s if shape["kind"] == "prefill"
                                         else 1))
            products = p["layers"] + p["unembed"]
            pairs = (s * (s + 1) // 2 if shape["kind"] == "prefill"
                     else s)             # a decode row sees its context
            live = 4 * cfg.hd * cfg.n_heads * cfg.n_layers * b * pairs
        require(ops.get("mm") == products, "products outside attention",
                label, ops, products)
        require(ops.get("bmm", 0) >= live, "attention products", label,
                ops, live)
        least = rec["t_bound_s"] * 1e3
        row = {"shape": shape, "flops_by_class": rec["flops_by_class"],
               "flops": rec["hlo_flops"], "bytes": rec["hlo_bytes"],
               "bottleneck": rec["bottleneck"], "least_ms": least,
               "measured_ms": ms, "fraction": least / ms,
               "products_outside_attention": products,
               "attention_over_live_pairs": ops.get("bmm", 0) / live,
               "predicted_peak_bytes": rec["mem_peak_bytes"],
               "predicted_argument_bytes":
                   rec["mem_argument_size_in_bytes"],
               "measured_peak_bytes": peak,
               "measured_before_bytes": before}
        if shape["kind"] == "decode":
            row["model_bounds_decode_bytes"] = e["decode_bytes"]
            row["bytes_over_model_bounds"] = rec["hlo_bytes"] \
                / e["decode_bytes"]
        out["steps"][label] = row
        cls = rec["flops_by_class"]
        measured_peak = ("not measured" if peak is None else
                         f"{peak / 1e9:.2f} GB" + (
                             "" if before is None else
                             f" ({before / 1e9:.2f} GB held before: "
                             f"{(peak - before) / 1e9:.2f} GB for the "
                             f"step)"))
        log(f"phase 9: {label} {b} x {s}: FLOPs bf16 products "
            f"{cls['products_bf16']:.4e}, f32 products "
            f"{cls['products_f32']:.4e}, other {cls['other']:.4e}; bytes "
            f"{rec['hlo_bytes']:.4e}; least {least:.3f} ms "
            f"({rec['bottleneck']}), measured {ms:.3f} ms, fraction "
            f"{least / ms:.4f}; products outside attention {products} = "
            f"closed form, attention {row['attention_over_live_pairs']:.3f}"
            f" x the live pairs'"
            + ("" if shape["kind"] != "decode" else
               f"; bytes {row['bytes_over_model_bounds']:.4f} x "
               f"model_bounds' decode_bytes")
            + f"; peak predicted {rec['mem_peak_bytes'] / 1e9:.2f} GB "
            f"({rec['mem_argument_size_in_bytes'] / 1e9:.2f} GB of "
            f"arguments), measured {measured_peak}  [{smi}]")

    for name, fn in kernel_calls.items():
        with CM.CostMode() as mode:
            fn()
        torch.cuda.synchronize()
        launches, charged = mode.cost.kernels[name]
        require(launches == 1 and list(mode.cost.kernels) == [name],
                "one kernel charged", name, mode.cost.kernels)
        out["kernels"][name] = {"charged_bytes": charged,
                                "table_bytes": table_bytes[name]}
        log(f"phase 9: {name:8s} charged {charged:.0f} B (operands + "
            f"results), bound's bytes {table_bytes[name]} B, difference "
            f"{charged - table_bytes[name]:.0f} B")

    path = out_dir / "dryrun_qwen3-8b_decode_32k.json"
    t1 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-8b", "--shape", "decode_32k", "--out", str(path)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    require(proc.returncode == 0, "dryrun CLI exit", proc.returncode,
            proc.stderr[-2000:])
    (rec,) = json.loads(path.read_text())
    require(rec["ok"] and rec["arch"] == "qwen3-8b", "dryrun record", rec)
    out["cli"] = {k: rec[k] for k in (
        "t_bound_s", "bottleneck", "hlo_flops", "hlo_bytes",
        "mem_peak_bytes", "fits_one_card")}
    out["cli"]["seconds"] = time.time() - t1
    out["seconds"] = time.time() - t0
    log(f"phase 9: dryrun CLI qwen3-8b decode_32k: exit 0 in "
        f"{out['cli']['seconds']:.1f} s, least {rec['t_bound_s'] * 1e3:.3f}"
        f" ms ({rec['bottleneck']}), peak {rec['mem_peak_bytes'] / 1e9:.1f}"
        f" GB, fits one card: {rec['fits_one_card']}; phase 9 took "
        f"{out['seconds']:.1f} s")
    return out


# Phase 10, multi-rank training on the one card: bytelm-100m at full width
# and the launcher's 8 x 512 global batch, and h2o-danube-1.8b at full
# width and depth at phase 8's 1 x 4096, its ranks subprocesses.
MR_STEPS = 3                        # the steps (a) and (b) compare
MR_MESHES = ((2, 2), (4, 1), (1, 4))
MR_SPLIT = ("2x2", "1x4")           # bytelm's runs with a model axis
MR_DANUBE_STEPS = 2                 # (e): danube at (1, 2)
MR_SAVE_AT, MR_TOTAL = 2, 4          # (c): the (2, 2) run's checkpoint, end
MR_TIMEOUT = 600                     # a rank group's wall-clock limit, s
MR_COLLECTIVES = ("all-gather", "reduce-scatter", "all-reduce", "broadcast")
# (f): the split MoE, RG-LRU and Mamba in bf16 at full width, depth cut
# (the registry's weights, seed 0): arch, layers, mesh, global batch, seq
MR_SPLIT_LAYERS = (("deepseek-moe-16b", 2, (2, 2), 8, 512),
                   ("recurrentgemma-9b", 3, (1, 4), 2, 512),
                   ("falcon-mamba-7b", 2, (1, 2), 2, 512))
MR_SPLIT_STEPS = 2
MR_MOE = "deepseek-moe-16b"             # its MoE layer costed alone
# The bf16 steps (f) holds to MR_BF16_TOL; later ones are printed beside
# two yardsticks that are not this split: deepseek-moe-16b's one process
# run again and falcon-mamba-7b on the data axis alone (the rounding of
# the reference's own microbatches).  Adam's first steps turn a few-ulp
# gradient difference into a whole bf16 step of a weight, so a split's
# reordered sums move bf16's step 2 past 2^-10 (``tools/split_spread.py``
# on an H100, PERF.md: deepseek-moe-16b's (1, 2) and (1, 4) splits by
# 3.4x and 3.7x, falcon-mamba-7b's (2, 1) by 2.8x; step 1 within the
# limits everywhere).
MR_SPLIT_HELD = {"deepseek-moe-16b": 1, "recurrentgemma-9b": 2,
                 "falcon-mamba-7b": 1}
# One process run again must repeat itself bit for bit: the MoE's
# dispatch and combine sum in a fixed order (models/common.py::_combine).
MR_SPLIT_REPEAT = ("deepseek-moe-16b",)
# (f) in float32, where reordered sums stay far below MR_SEQ_F32_TOL:
# arch -> global batch, both steps held, the same layers, widths and
# meshes as its bf16 case beside a float32 one process.  deepseek-moe-16b's
# batch is cut from 8 to its first 4 rows (2 a data rank) to keep phase 10
# within its time; falcon-mamba-7b keeps its 2 x 512.
MR_SPLIT_F32 = {"deepseek-moe-16b": 4, "falcon-mamba-7b": 2}
MR_SPLIT_DATA = {"falcon-mamba-7b": (2, 1)}
# (f)'s split serving: arch, mesh, rows, prompt, true lengths, decode steps
# and context, in float32 (held at test_torch_serve_step.py's tolerance)
MR_SERVE = ("recurrentgemma-9b", (1, 4), 2, 256, (256, 200), 3, 512)
MR_SERVE_TOL = dict(atol=1e-4, rtol=1e-4)
# (g): the sequence split (fewer rows than data ranks), full width, depth
# cut, the registry's weights (seed 0).  Training: arch, layers (None:
# all), mesh, global batch, seq, dtype, and the steps of each metric held
# to the dtype's tolerance (MR_BF16_TOL, MR_SEQ_F32_TOL).  falcon-mamba's
# split scan folds each block's carry into a block scanned from zero, an
# association of the f32 sums that one process's scan does not use; in
# bf16 the casts behind it round the difference, and step 1's grad norm
# moved 1.153e-3 from one process's on an H100 (PERF.md, §6), so its
# bf16 grad norm is printed, and held in float32.  whisper-tiny at full
# width and depth: its decoder tokens split, its 1,500 frames whole on
# every rank (the encoder and the cross-attention K/V projections run
# whole there), bf16's step 1 and float32's two steps held.
MR_SEQ_TRAIN = (
    ("bytelm-100m", None, (4, 1), 2, 512, "bfloat16",
     {"loss": 2, "grad_norm": 2}),
    ("falcon-mamba-7b", 2, (2, 1), 1, 512, "bfloat16",
     {"loss": 1, "grad_norm": 0}),
    ("falcon-mamba-7b", 2, (2, 1), 1, 512, "float32",
     {"loss": 1, "grad_norm": 1}),
    ("whisper-tiny", None, (4, 1), 1, 512, "bfloat16",
     {"loss": 1, "grad_norm": 1}),
    ("whisper-tiny", None, (4, 1), 1, 512, "float32",
     {"loss": 2, "grad_norm": 2}))
MR_SEQ_F32_TOL = {"loss_rel": 2 ** -16, "gnorm_rel": 2 ** -16}
# serving in float32, one row at each mesh: arch, layers, prompt, context
# (danube's prompt outruns its 4,096-slot ring; whisper-tiny's state holds
# its block of the 1,500 frames' K/V)
MR_SEQ_SERVE = (("h2o-danube-1.8b", 2, 4352, 8192),
                ("recurrentgemma-9b", 3, 512, 1024),
                ("falcon-mamba-7b", 2, 512, 512),
                ("whisper-tiny", None, 512, 1024))
MR_SEQ_MESHES = ((4, 1), (2, 2))
MR_SEQ_DECODE = 16


def _kernel_counters():
    """The pipeline's hand kernels: name -> wrapper (its ``launches``)."""
    from repro_torch.kernels import ragged_transcode as rt
    from repro_torch.kernels import utf8_validate as kval
    return {"validate": kval.validate_kernel, "ronepass": rt.ronepass_kernel,
            "rcount": rt.rcount_kernel, "rwrite": rt.rwrite_kernel}


def collective_closed_form(rt, n_micro: int, remat: bool, dtype_bytes: dict,
                           rows_split: bool = True, tokens: int = 0) -> dict:
    """Bytes of one sharded step's collectives by kind, from the specs
    and the shapes alone, under ``CostMode``'s convention (a collective is
    charged its output): per microbatch, each weight's gathers
    (``Leaf.uses`` in the forward, again in a layer's remat recompute; a
    leaf the layers use without ``gather`` once, when the microbatch
    starts) over its spec's axes but the model axis where the layer
    computes on the leaf's own block of it, one backward reduction per
    forward gather (reduce-scatter over the batch axes its spec names,
    in float32, an all-reduce over those it does not), the label count
    and the CE (4 B each); per step, the gradient norm (4 B) and the
    ZeRO-1 update: an all-gather of each further-split slice, a
    broadcast of each layer whose moments one data rank holds.  With a
    model axis (a dense decoder whose heads and hidden units divide it,
    ``tokens`` a microbatch's on this rank): per layer Megatron's g after
    attention and after the MLP (float32 (tokens, d_model)), attention's
    again in the recompute (which stops at the layer's last saved tensor,
    the MLP's output product's inputs, so the MLP's g is not re-run), and
    their f in the backward, one activation for each column product
    (q, k, v; the MLP's two), summed over model before it is rounded;
    with a split vocabulary the embedding's g,
    and per CE chunk its max, its sum and gold logit, and the
    unembedding's f."""
    mesh = rt.mesh
    batch = set(rt.batch_axes)
    out = dict.fromkeys(MR_COLLECTIVES, 0)

    def size(axes):
        return mesh.axis_size(axes) if axes else 1

    for name, lf in rt.leaves.items():
        b = dtype_bytes[name]
        # the layers compute on a leaf's own block along model (``local``)
        dims = [axes if axes != (rt.tp,) else () for axes in lf.dims]
        n = 1
        for s in lf.shape:
            n *= s
        shard = n
        for axes in lf.dims:
            shard //= size(axes)
        gathers, cur = 0, shard
        for axes in dims:
            if size(axes) > 1:
                cur *= size(axes)
                gathers += cur * b
        if lf.reached:
            # a layer's leaves are gathered again in its remat recompute,
            # but the cross-attention K/V projections, which run once,
            # outside the decoder layers (models.encdec._enc_kv)
            head = name.split(".")[0]
            inside = (head.startswith("seg") or head in ("enc", "dec")) \
                and not name.endswith(("xattn.wk", "xattn.wv"))
            uses = lf.uses * (2 if remat and inside else 1)
            back = lf.uses
        else:
            uses = back = 1
        out["all-gather"] += n_micro * uses * gathers
        cur = n
        for axes in lf.dims:
            if axes and not all(a in batch for a in axes):
                cur //= size(axes)
        rs = 0
        for axes in lf.dims:
            if axes and all(a in batch for a in axes) and size(axes) > 1:
                cur //= size(axes)
                rs += cur * 4
        out["reduce-scatter"] += n_micro * back * rs
        named = {a for axes in lf.dims for a in axes}
        rest = tuple(a for a in rt.batch_axes if a not in named)
        if rest and size(rest) > 1:
            out["all-reduce"] += n_micro * back * cur * 4
        ms = lf.moments()
        if ms.dim is not None and size(ms.extra) > 1:
            out["all-gather"] += shard * b
        if ms.lead and size(ms.lead) > 1:
            out["broadcast"] += shard * b
    if rows_split and size(rt.batch_axes) > 1:
        out["all-reduce"] += n_micro * 2 * 4
    out["all-reduce"] += 4
    if rt.tp is not None:
        cfg = rt.model.cfg
        m, d = mesh.axis_size(rt.tp), cfg.d_model
        require(cfg.pattern == "dense" and cfg.n_heads % m == 0
                and cfg.n_kv_heads % m == 0 and cfg.d_ff % m == 0
                and not cfg.qkv_bias and not cfg.qk_norm,
                "the closed form covers dense decoders that split whole",
                cfg.name)
        act = tokens * d * 4
        out["all-reduce"] += n_micro * cfg.n_layers * act * (
            2 + (1 if remat else 0) + 3 + 2)
        if cfg.vocab % m == 0:
            table = dtype_bytes["embed.table"]
            out["all-reduce"] += n_micro * (tokens * d * table
                                            + tokens * 3 * 4 + act)
    return out


def seq_closed_form(rt, cfg, dtype_bytes: dict, batch: int, seq: int) -> dict:
    """Bytes of one step's collectives by kind under the sequence split
    (``batch`` rows of ``seq`` positions over ``n`` data ranks, no model
    axis, remat "full"), under ``CostMode``'s convention (a collective's
    output): :func:`collective_closed_form`'s weight gathers and
    reductions, label count and CE, and each layer's sequence
    collectives, forward and again in its recompute: attention's keys
    and values all-gathered (every position, in the model's dtype) with
    their int32 positions, their gradients reduce-scattered (float32);
    Mamba's conv halo (each block's last ``min(d_conv - 1, S / n)``
    positions of its inner channels) and its scan's carries (``(a_0 ...
    a_last, h_last)`` of each block, float32) all-gathered, their
    gradients reduce-scattered.  An encoder-decoder's decoder layers are
    attention's; its encoder and cross-attention, on every frame on every
    rank, add no sequence collective."""
    from repro_torch.launch import mesh as meshmod

    mesh = rt.mesh
    n = mesh.axis_size(meshmod.dp_axes(mesh))
    require(rt.tp is None, "the sequence split's closed form has no model "
            "axis", dict(mesh.shape))
    out = collective_closed_form(rt, 1, True, dtype_bytes)
    xb = {"bfloat16": 2, "float32": 4}[cfg.dtype]
    sl = seq // n
    segments = [("dense", cfg.n_layers)] if not hasattr(cfg, "segments") \
        else cfg.segments()
    for kind, count in segments:
        if kind in ("dense", "moe"):
            kvd = cfg.n_kv_heads * cfg.hd
            out["all-gather"] += count * 2 * (2 * batch * seq * kvd * xb
                                              + batch * seq * 4)
            out["reduce-scatter"] += count * 2 * batch * sl * kvd * 4
        elif kind == "mamba":
            mc = cfg.mamba_cfg()
            t = min(mc.d_conv - 1, sl)
            di, ns = mc.d_inner, mc.d_state
            out["all-gather"] += count * 2 * (batch * n * t * di * xb
                                              + n * 2 * batch * di * ns * 4)
            out["reduce-scatter"] += count * (batch * t * di * 4
                                              + 2 * batch * di * ns * 4)
        else:
            require(False, "the sequence split's closed form covers dense "
                    "and Mamba layers", kind)
    return out


def encdec_whole_products(cfg, batch: int, aten_remat: bool) -> float:
    """Product FLOPs of one training step's encoder and cross-attention
    K/V projections over every frame (whole on every rank of the sequence
    split): the forward, the backward (twice it) and the encoder layers'
    remat recompute, which stops before each layer's last product (the
    MLP's output) where that product is aten ``mm``, which saves its
    inputs (``aten_remat``: float32, or off the card), and runs whole
    where it is ``common._Mm32`` (bf16 on the card)."""
    t, d, hd, f = cfg.n_audio_frames, cfg.d_model, cfg.hd, cfg.d_ff
    h, kv, b = cfg.n_heads, cfg.n_kv_heads, batch
    layer = 2 * b * t * (d * (h + 2 * kv) * hd + h * hd * d + 3 * d * f) \
        + 4 * b * t * h * hd * t
    cross = 4 * b * t * d * kv * hd * cfg.n_layers
    early = 2 * b * t * f * d if aten_remat else 0
    return float(cfg.n_layers * (4 * layer - early) + 3 * cross)


def rank_products(cfg, batch: int, seq: int, data: int, model: int) -> dict:
    """A rank's product FLOPs outside attention (``mm``) of one step of a
    dense decoder at (``data``, ``model``) on the card: :func:`train_flops`'
    over ``data * model``, the unembedding's over ``data`` alone where the
    vocabulary does not divide ``model`` (the table stays whole)."""
    p = dense_products(cfg, batch * seq)
    whole_vocab = cfg.vocab % model != 0
    return {"layers": 4 * p["layers"] / (data * model),
            "unembed": 3 * p["unembed"] / (data * (1 if whole_vocab
                                                   else model)),
            "one_process": 4 * p["layers"] + 3 * p["unembed"]}


def rank_job(path: str) -> int:
    """One rank of phase 10 (``chip_smoke.py --rank-job JOB``): joins the
    process group of the job, runs its cases, and writes what it saw to
    ``<work>/rank<r>.json``.  Cases:

      * ``train``: ``arch`` at ``mesh`` (``launch.mesh.make_host_mesh``),
        its weights the launcher's (the registry's, seed 0), the step
        ``make_train_step(..., mesh=)`` at the launcher's learning rate
        for ``total`` steps, each rank's batch from its own
        ``TextPipeline`` (``host_id`` its data coordinate; the device's
        UTF-8 -> UTF-32 decode on, one ronepass launch a batch), for
        ``steps`` steps: each step's metrics; the pipeline's kernel
        launches; the resident parameter and moment bytes after step 1
        beside the specs'; the parameters after step ``compare_at``
        against the checkpoint of run (a) (rank 0); a checkpoint after
        ``save_at``; step ``time_at`` split into gathers, forward and
        backward, model-axis reductions, data reductions and update (each
        collective between device synchronisations); step ``cost_at``
        under ``CostMode``: its collectives' bytes by kind beside
        ``collective_closed_form``, its product FLOPs beside
        ``rank_products``; the layers that computed whole over the model
        axis (``models.shardctx.whole_layers``), with the count that does
        not divide.  With ``seed`` and ``batch_file`` in the job, the
        model is the registry's config built from that seed (phase 8's
        danube) and every step takes the file's batch;
      * ``sync``: ``hierarchical_grad_sync`` over a (pod 2, data 2) mesh
        on random gradients of the arch's parameter shapes: against a
        plain float32 all-reduce, and the pod hop's bytes against the
        uncompressed sync's (``CostMode``);
      * ``single``: one process's steps (no mesh) of the job's model on
        its fixed batch: each step's metrics;
      * ``serve``: the model bound to a (1, n) mesh as the dry run's
        serving cells bind it (or one process, ``mesh`` null), a prefill
        and teacher-forced decode steps on the job's prompts; the logits
        saved to ``<work>/<label>_rank<r>.pt``, each k and v leaf's bytes
        beside its ``state_specs`` shard, the layers noted whole.
    A case's own ``cfg``, ``seed``, ``batch_file``, ``batch`` and ``seq``
    stand for the job's."""
    import gc

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    with open(path) as f:
        job = json.load(f)
    from repro_torch.launch import train as launch_train

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(1)
    dev = launch_train.rank_device(job["device"], job["backend"],
                                   int(os.environ["LOCAL_RANK"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(job["backend"], init_method=job["init"],
                            rank=rank, world_size=world)
    res = {"rank": rank}
    try:
        for case in job["cases"]:
            fn = {"train": _rank_train, "sync": _rank_sync,
                  "single": _rank_single, "serve": _rank_serve}[case["kind"]]
            res[case["label"]] = fn(case, job, dev)
            if dev.type == "cuda":      # the ranks share the card's memory
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(Path(job["work"]) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)
    return 0


def _sync_dev(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank_train(case, job, dev) -> dict:
    import contextlib

    import torch
    import torch.distributed as dist
    from repro_torch import configs, costmodel
    from repro_torch.data import pipeline as pipemod
    from repro_torch.launch import mesh as meshmod
    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import optimizer as O
    from repro_torch.train import sharding as SH
    from repro_torch.train import train_step as TS

    from repro_torch.models import shardctx

    rank = dist.get_rank()
    job = {**job, **case}
    mesh = meshmod.make_host_mesh(model=case["mesh"][1])
    require(tuple(mesh.shape.values()) == tuple(case["mesh"]), "mesh",
            dict(mesh.shape))
    fam, cfg, model = _rank_model(job, dev)
    like = launch_train.state_like(model)
    opt_cfg = _rank_opt(case)
    step_fn = TS.make_train_step(model, fam, opt_cfg, mesh=mesh,
                                 global_batch=job["batch"])
    rt = step_fn.runtime
    dp = meshmod.dp_axes(mesh)
    if "batch_file" in job:
        # this rank's rows of the batch, or all of them when there are
        # fewer than the data ranks (the step then runs the whole batch)
        n, h = mesh.axis_size(dp), mesh.index(dp)
        if job["batch"] % n or job["batch"] < n:
            n, h = 1, 0
        fixed = {k: v[h::n].to(dev) for k, v in torch.load(
            job["batch_file"], weights_only=False).items()}
    else:
        pipe = pipemod.TextPipeline(pipemod.PipelineConfig(
            seq_len=job["seq"], global_batch=job["batch"],
            host_id=mesh.index(dp), n_hosts=mesh.axis_size(dp),
            emit="codepoints"), device=dev)
    counters = _kernel_counters()
    for k in counters.values():
        k.launches = 0
    out = {"mesh": dict(mesh.shape), "coord": mesh.coord, "steps": []}
    dtype_bytes = {n: p.element_size() for n, p in rt.params().items()}
    rows = job["batch"] // mesh.axis_size(dp)
    with shardctx.whole_layers() as whole:
        for i in range(1, case["steps"] + 1):
            if "batch_file" in job:
                batch = fixed
            else:
                batch = pipe.next_batch()
                batch = {k: batch[k] for k in ("tokens", "labels")}
            timing = contextlib.nullcontext()
            if i == case.get("time_at"):
                timing = _timed_collectives(dev, SH, O)
            cost = contextlib.nullcontext()
            if i == case.get("cost_at"):
                cost = costmodel.CostMode()
            _sync_dev(dev)
            t0 = time.perf_counter()
            with timing as tm, cost as cm:
                met = step_fn(batch)
            _sync_dev(dev)
            ms = (time.perf_counter() - t0) * 1e3
            out["steps"].append({"loss": float(met["loss"]),
                                 "grad_norm": float(met["grad_norm"]),
                                 "lr": float(met["lr"]), "ms": ms})
            if tm is not None:
                out["split_ms"] = tm.split(ms)
            if cm is not None and case.get("seq_cost"):
                out["collectives"] = {
                    "costmode_bytes": {k: cm.cost.coll_bytes[k]
                                       for k in MR_COLLECTIVES},
                    "costmode_counts": {k: cm.cost.coll_counts[k]
                                        for k in MR_COLLECTIVES},
                    "closed_form_bytes": seq_closed_form(
                        rt, cfg, dtype_bytes, job["batch"], job["seq"])}
                out["products_all"] = (cm.cost.flops_by_class["products_bf16"]
                                       + cm.cost.flops_by_class["products_f32"])
            elif cm is not None:
                out["collectives"] = {
                    "costmode_bytes": {k: cm.cost.coll_bytes[k]
                                       for k in MR_COLLECTIVES},
                    "costmode_counts": {k: cm.cost.coll_counts[k]
                                        for k in MR_COLLECTIVES},
                    "closed_form_bytes": collective_closed_form(
                        rt, 1, bool(getattr(cfg, "remat", False)), dtype_bytes,
                        tokens=rows * job["seq"])}
                ops = cm.cost.flops_by_op
                out["products"] = {
                    "mm": ops.get("mm", 0.0), "bmm": ops.get("bmm", 0.0),
                    "closed_form": rank_products(
                        cfg, job["batch"], job["seq"], mesh.axis_size(dp),
                        mesh.shape["model"])}
            if i == 1:
                out["resident_bytes"] = rt.resident_bytes(step_fn.opt_state)
                out["spec_bytes"] = rt.spec_bytes()
            if i == case.get("compare_at"):
                out["vs_a"] = _compare_whole(rt, case["a_ckpt"],
                                             case["compare_at"], like, rank)
            if i == case.get("save_at"):
                launch_train.save_checkpoint(case["ckpt_dir"], i, step_fn,
                                             model)
    out["whole_layers"] = sorted(list(w) for w in whole)
    if case.get("moe_cost"):
        out["moe_cost"] = _moe_layer_cost(cfg, step_fn.context, dev, rows,
                                          job["seq"], mesh)
    out["whole_leaves"] = sorted(
        n for n, lf in rt.leaves.items()
        if "model" not in {a for axes in lf.dims for a in axes}
        and lf.reached and math.prod(lf.shape) > cfg.d_model)
    _sync_dev(dev)
    out["launches"] = {n: k.launches for n, k in counters.items()}
    del step_fn, model
    return out


def _rank_model(job, dev):
    """``(family, cfg, model)``: the job's ``cfg`` (of its ``family``,
    ``lm`` unless given) built from its ``seed`` (remat "full"), or the
    registry's ``arch``."""
    import torch
    from repro_torch.models import registry

    if "seed" in job and job.get("family") == "encdec":
        from repro_torch.models.encdec import EncDecConfig
        cfg = EncDecConfig(**dict(job["cfg"], remat=True))
        return "encdec", cfg, registry.build(
            cfg, device=dev, generator=torch.Generator(
                device=dev).manual_seed(job["seed"]))
    if "seed" in job:
        from repro_torch.models.lm import LMConfig
        fields = dict(job["cfg"], remat=True, remat_policy="full")
        cfg = LMConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in fields.items()})
        return "lm", cfg, registry.build(
            cfg, device=dev, generator=torch.Generator(
                device=dev).manual_seed(job["seed"]))
    return registry.get(job["arch"], reduced=job["reduced"], device=dev)


def _rank_opt(case):
    from repro_torch.train import optimizer as O
    return O.AdamWConfig(lr=3e-4, total_steps=case["total"],
                         warmup_steps=max(case["total"] // 20, 5))


def _rank_single(case, job, dev) -> dict:
    """One process's ``steps`` steps of the case's model (no mesh) on its
    fixed batch, with :func:`_rank_train`'s optimizer settings."""
    import contextlib

    import torch
    from repro_torch import costmodel
    from repro_torch.train import train_step as TS

    job = {**job, **case}
    fam, cfg, model = _rank_model(job, dev)
    step_fn = TS.make_train_step(model, fam, _rank_opt(case))
    batch = {k: v.to(dev) for k, v in torch.load(
        job["batch_file"], weights_only=False).items()}
    steps, out = [], {}
    for i in range(1, case["steps"] + 1):
        cost = costmodel.CostMode() if i == case.get("cost_at") \
            else contextlib.nullcontext()
        _sync_dev(dev)
        t0 = time.perf_counter()
        with cost as cm:
            met = step_fn(batch)
        _sync_dev(dev)
        steps.append({"loss": float(met["loss"]),
                      "grad_norm": float(met["grad_norm"]),
                      "lr": float(met["lr"]),
                      "ms": (time.perf_counter() - t0) * 1e3})
        if cm is not None:
            out["products_all"] = (cm.cost.flops_by_class["products_bf16"]
                                   + cm.cost.flops_by_class["products_f32"])
    params = sum(p.numel() for p in model.parameters())
    del step_fn, model
    return {"steps": steps, "params": params, **out}


def _rank_serve(case, job, dev) -> dict:
    """Prefill and teacher-forced decode steps of the case's model, bound
    to a (1, n) mesh as the dry run's serving cells bind it (no FSDP),
    or in one process (``mesh`` null); an encoder-decoder's prefill takes
    the whole prompt and the job's frames."""
    import contextlib

    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshmod
    from repro_torch.models import shardctx
    from repro_torch.serve import kvcache, serve_step
    from repro_torch.train import sharding as SH

    job = {**job, **case}
    fam, cfg, model = _rank_model(job, dev)
    ins = {k: v.to(dev) for k, v in torch.load(
        job["batch_file"], weights_only=False).items()}
    toks, lens, feed = ins["tokens"], ins["lens"], ins["feed"]
    rows, context = toks.shape[0], case["context"]
    cap = kvcache.capacity_for(cfg, context)
    with torch.no_grad():                # the whole state's leaves
        whole = _state_leaves(
            model.init_state(ins["frames"], rows, cap) if fam == "encdec"
            else kvcache.init_state(model, cfg, rows, context))
    scope, mesh = contextlib.ExitStack(), None
    if case["mesh"] is not None:
        mesh = meshmod.make_host_mesh(model=case["mesh"][1])
        require(tuple(mesh.shape.values()) == tuple(case["mesh"]), "mesh",
                dict(mesh.shape))
        rt = SH.bind(model, fam, mesh, SH.param_specs(model, mesh,
                                                      fsdp=None),
                     None, ("data",))
        # fewer rows than data ranks: the sequence split (its state's
        # slots and channels over the data ranks too)
        seq = ("data",) if mesh.shape["data"] > rows else ()
        scope.enter_context(shardctx.use(
            dp_axes=("data",), dp_size=mesh.shape["data"], mesh=mesh,
            batch_axes=(), seq_axes=seq))
        scope.enter_context(rt.swapped())
    logits = []
    with torch.no_grad():
        _sync_dev(dev)
        t0 = time.perf_counter()
        with scope, shardctx.whole_layers() as noted:
            if fam == "encdec":     # the whole prompt against the frames
                pre, dec = serve_step.make_encdec_steps(model)
                lg, state = pre(model, ins["frames"], toks, cap)
                mine = _state_leaves(state)
                logits.append(lg.float().cpu())
                for j in range(feed.shape[1]):
                    _, lg, state = dec(model, feed[:, j: j + 1], state)
                    logits.append(lg.float().cpu())
            else:
                pre = serve_step.make_prefill(model, fam)
                dec = serve_step.make_decode(model, fam)
                state = kvcache.init_state(model, cfg, rows, context)
                mine = _state_leaves(state)
                lg, state = pre(model, toks, lens, state)
                logits.append(lg.float().cpu())
                pos = lens.clone()
                for j in range(feed.shape[1]):
                    _, lg, state = dec(model, feed[:, j: j + 1], pos,
                                       state, None)
                    logits.append(lg.float().cpu())
                    pos = pos + 1
        _sync_dev(dev)
        ms = (time.perf_counter() - t0) * 1e3
    kv, leaves = {}, {}
    for name, t in whole.items():
        size = t.element_size()
        want = math.prod(t.shape) * size
        if mesh is not None:
            spec = SH.state_specs({"t": t}, mesh)["t"]
            want = math.prod(SH.shard_shape(t.shape, spec, mesh)) * size
        leaves[name] = [mine[name].numel() * size, want,
                        list(mine[name].shape)]
        if name.endswith((".k", ".v")):
            kv[name] = leaves[name]
    path = Path(job["work"]) / f"{case['label']}_rank{dist.get_rank()}.pt"
    torch.save(logits, path)
    del model, state
    return {"logits_file": str(path), "kv": kv, "leaves": leaves, "ms": ms,
            "whole_layers": sorted(list(w) for w in noted)}


def _state_leaves(state) -> dict:
    """A decode state's tensors by dotted name, an encoder-decoder's
    ``enc_kv`` pair as ``enc_kv.0`` and ``enc_kv.1``."""
    from repro_torch.models import weights
    if isinstance(state.get("enc_kv"), tuple):
        state = {**state, "enc_kv": dict(enumerate(state["enc_kv"]))}
    return weights._flatten(state)


def moe_closed_form(mc, d: int, rows: int, seq: int, data: int, model: int,
                    x_bytes: int) -> dict:
    """One forward and backward of ``common.moe`` on ``rows x seq`` tokens
    of each of ``data`` ranks at (``data``, ``model``), its weights whole
    on the rank (not bound): the rank's product FLOPs (its experts or
    hidden units over slots ``ceil(cap / data)`` of every expert's
    buffer, the router on its own tokens, the shared MLP's share), one
    process's on the global batch, and the collectives' bytes by kind
    under ``CostMode``'s convention (a collective's output)."""
    t = rows * seq
    tg = t * data
    e, k, f = mc.n_experts, mc.top_k, mc.d_ff
    cap = max(1, int(tg * k / e * mc.capacity_factor),
              min(tg * k, mc.min_capacity))
    c = -(-cap // data)
    split = model > 1 and (e % model == 0 or f % model == 0)
    shared = f * mc.n_shared
    sh_split = model > 1 and shared % model == 0
    experts = 18 * e * d * f
    out = {"cap": cap, "slots": c,
           "products": experts * c / (model if split else 1)
           + 6 * t * d * e + 18 * t * d * shared / (model if sh_split else 1),
           "one_process": experts * cap + 6 * tg * d * e + 18 * tg * d
           * shared}
    f4 = 4
    out["all-gather"] = tg * k * 8 + tg * d * x_bytes + tg * k * f4 \
        + tg * d * f4
    out["reduce-scatter"] = (2 * t * d + t * k) * f4
    out["all-reduce"] = e * f4 + ((2 * t * d + t * k) * f4 if split else 0) \
        + (3 * t * d * f4 if sh_split else 0)
    out["broadcast"] = 0
    return out


def _moe_layer_cost(cfg, context: dict, dev, rows: int, seq: int,
                    mesh) -> dict:
    """``common.moe`` alone, forward and backward under ``CostMode``
    inside the sharded step's ``context``, on random weights of ``cfg``'s
    MoE (whole on the rank, so no weight is gathered) and this rank's
    ``rows x seq`` random tokens: its product FLOPs and collectives'
    bytes beside :func:`moe_closed_form`."""
    import torch
    from repro_torch import costmodel
    from repro_torch.launch import mesh as meshmod
    from repro_torch.models import common as C
    from repro_torch.models import shardctx

    mc = cfg.moe_cfg()
    gen = torch.Generator(device=dev).manual_seed(7)
    moe = C.MoE(mc, cfg.torch_dtype, dev, gen)
    x = torch.randn((rows, seq, cfg.d_model), generator=gen, device=dev) \
        .to(cfg.torch_dtype).requires_grad_(True)
    with shardctx.use(**context), shardctx.whole_layers() as noted, \
            costmodel.CostMode() as cm:
        y, aux = C.moe(moe, mc, x)
        (y.float().sum() + aux).backward()
    _sync_dev(dev)
    c = cm.cost
    dp = meshmod.dp_axes(mesh)
    return {"products": c.flops_by_class["products_bf16"]
            + c.flops_by_class["products_f32"],
            "bytes": {k: c.coll_bytes[k] for k in MR_COLLECTIVES},
            "counts": {k: c.coll_counts[k] for k in MR_COLLECTIVES},
            "whole_layers": sorted(list(w) for w in noted),
            "closed_form": moe_closed_form(
                mc, cfg.d_model, rows, seq, mesh.axis_size(dp),
                mesh.shape["model"], x.element_size())}


def _compare_whole(rt, ckpt_dir, step, like, rank) -> dict:
    """Every parameter gathered whole (a collective), and on rank 0 held
    against run (a)'s checkpoint at ``step``: the largest excess over
    ``MR_PARAM_BOUND`` and the largest difference."""
    import torch
    from repro_torch.models import weights
    from repro_torch.train import checkpoint as CK

    whole = {n: rt.full(n, p.detach()) for n, p in rt.params().items()}
    if rank != 0:
        return None
    tree = CK.restore(ckpt_dir, step, {"params": like["params"]})
    want = weights.unstack_reference(rt.model, tree["params"])
    excess, diff, n_diff = -1.0, 0.0, 0
    for n, w in want.items():
        g = whole[n].float().cpu()
        w = w.float()
        d = (g - w).abs()
        bound = MR_PARAM_BOUND["lr_sum"] + MR_PARAM_BOUND["rel"] * w.abs()
        excess = max(excess, float((d - bound).max()))
        diff = max(diff, float(d.max()))
        n_diff += int((d > 0).sum())
    return {"param_excess_over_bound": excess, "param_max_abs_diff": diff,
            "params_differing": n_diff}


class _timed_collectives:
    """Times a step's collectives, each between device synchronisations:
    ``train.sharding``'s all-gathers, reduce-scatters, all-reduces and
    broadcasts, and ``optimizer.adamw_update_sharded`` as a whole."""

    def __init__(self, dev, SH, O):
        self.dev, self.SH, self.O = dev, SH, O
        self.t = {"all_gather": 0.0, "reduce_scatter": 0.0,
                  "all_reduce": 0.0, "model_reduce": 0.0, "broadcast": 0.0,
                  "update": 0.0}
        self.in_update = False

    def _wrap(self, mod, name, key):
        real = getattr(mod, name)

        def run(*a, **k):
            _sync_dev(self.dev)
            t0 = time.perf_counter()
            out = real(*a, **k)
            _sync_dev(self.dev)
            dt = (time.perf_counter() - t0) * 1e3
            if key == "update":
                self.t["update"] += dt
            elif not self.in_update:
                # an all-reduce over the model axis alone: Megatron's f
                # and g, the vocabulary's sums, a cut leaf's gradient sum
                over_model = key == "all_reduce" and a[2] == "model"
                self.t["model_reduce" if over_model else key] += dt
            return out
        return real, run

    def __enter__(self):
        self.saved = []
        for name in ("all_gather", "reduce_scatter", "all_reduce",
                     "broadcast"):
            real, run = self._wrap(self.SH, name, name)
            self.saved.append((self.SH, name, real))
            setattr(self.SH, name, run)
        real, run = self._wrap(self.O, "adamw_update_sharded", "update")
        outer = self

        def update(*a, **k):
            outer.in_update = True
            try:
                return run(*a, **k)
            finally:
                outer.in_update = False
        self.saved.append((self.O, "adamw_update_sharded", real))
        self.O.adamw_update_sharded = update
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)
        return False

    def split(self, step_ms: float) -> dict:
        t = self.t
        reduce = t["reduce_scatter"] + t["all_reduce"]
        return {"step_ms": step_ms, "gather_ms": t["all_gather"],
                "model_reduce_ms": t["model_reduce"], "reduce_ms": reduce,
                "update_ms": t["update"],
                "forward_backward_ms": step_ms - t["all_gather"]
                - t["model_reduce"] - reduce - t["update"]}


def _rank_sync(case, job, dev) -> dict:
    import torch
    import torch.distributed as dist
    from repro_torch import costmodel
    from repro_torch.launch import mesh as meshmod
    from repro_torch.models import registry
    from repro_torch.train import grad as G

    rank = dist.get_rank()
    mesh = meshmod.make_mesh({"pod": 2, "data": dist.get_world_size() // 2})
    _, _, meta = registry.get(job["arch"], reduced=job["reduced"],
                              device="meta")
    gen = torch.Generator(device=dev).manual_seed(1000 + rank)
    grads = {n: torch.randn(p.shape, generator=gen, device=dev) * 1e-3
             for n, p in meta.named_parameters()}
    n_ici = mesh.axis_size("data")
    err = G.init_error_feedback(grads, ici_axis_size=n_ici)
    out = {}
    for compress in (True, False):
        _sync_dev(dev)
        t0 = time.perf_counter()
        with costmodel.CostMode() as cm:
            got, _ = G.hierarchical_grad_sync(grads, err, mesh=mesh,
                                              compress=compress)
        _sync_dev(dev)
        out["int8" if compress else "f32"] = {
            "ms": (time.perf_counter() - t0) * 1e3,
            "bytes": {k: cm.cost.coll_bytes[k] for k in MR_COLLECTIVES}}
        if compress:
            synced = got
    rel = 0.0
    for n, g in grads.items():
        plain = g.clone()
        dist.all_reduce(plain)
        rel = max(rel, float((synced[n] - plain).abs().max()
                             / (plain.abs().max() + 1e-12)))
    shard = sum(e.numel() for e in err.values())
    i8, f32 = out["int8"]["bytes"], out["f32"]["bytes"]
    out.update({
        "max_rel_err": rel, "shard_elements": shard,
        "pod_hop_int8_bytes": i8["all-gather"] - f32["all-gather"],
        "pod_hop_f32_bytes": f32["all-reduce"],
        "pod_hop_int8_payload": shard, "pod_hop_f32_payload": 4 * shard})
    return out


def spawn_ranks(n: int, job: dict, work: Path, env: dict) -> list:
    """Run ``job`` on ``n`` rank processes (``--rank-job``); every rank
    must exit 0 within ``MR_TIMEOUT`` (a failed rank kills the others and
    fails the phase).  Returns each rank's result."""
    return spawn_groups([(n, job, work)], env)[0]


def spawn_groups(groups: list, env: dict) -> list:
    """:func:`spawn_ranks` for several ``(n, job, work)`` rank groups at
    once, each in a process group of its own: a failed rank kills every
    group's.  Returns each group's ranks' results."""
    procs = []
    try:
        for n, job, work in groups:
            path = work / f"job_{time.monotonic_ns()}.json"
            path.write_text(json.dumps(job))
            for r in range(n):
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--rank-job", str(path)],
                    env=dict(env, RANK=str(r), LOCAL_RANK=str(r),
                             WORLD_SIZE=str(n)),
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, cwd=str(ROOT)))
        deadline = time.monotonic() + MR_TIMEOUT
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            require(not failed and time.monotonic() < deadline,
                    "phase 10 rank failed or timed out",
                    [(p.returncode, p.communicate()[0][-3000:])
                     for p in failed])
            time.sleep(0.1)
        logs = [p.communicate()[0] for p in procs]
        require(all(p.returncode == 0 for p in procs), "phase 10 ranks",
                [(p.returncode, lg[-3000:]) for p, lg in zip(procs, logs)])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [[json.loads((Path(job["work"]) / f"rank{r}.json").read_text())
             for r in range(n)] for n, job, _work in groups]


def torchrun(n: int, args: list, env: dict, timeout: int = MR_TIMEOUT):
    """``python -m torch.distributed.run --standalone`` with ``n`` ranks of
    the train launcher, in a session of its own (a timeout kills the
    ranks too); fails the phase unless it exits 0."""
    import signal as signal_mod

    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "-m", "repro_torch.launch.train",
         *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=str(ROOT), start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal_mod.SIGKILL)
            proc.wait()
    require(proc.returncode == 0, "torch.distributed.run", n, args,
            out[-2000:], err[-3000:])
    return out


def _metrics(path: Path) -> list:
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def torch_save_batch(batch: dict, path: Path) -> None:
    import torch
    torch.save({k: v.cpu() for k, v in batch.items()}, path)


def _log_split(label: str, step: int, sp: dict, smi: str) -> None:
    log(f"phase 10: {label} step {step} on rank 0 (correctness run: gloo "
        f"ranks share one card, each collective between synchronisations):"
        f" {sp['step_ms']:.1f} ms = gathers {sp['gather_ms']:.1f} + forward"
        f" and backward {sp['forward_backward_ms']:.1f} + model-axis "
        f"reductions {sp['model_reduce_ms']:.1f} + data reductions "
        f"{sp['reduce_ms']:.1f} + update {sp['update_ms']:.1f}  [{smi}]")


def _log_model_axis(label: str, step: int, r: dict) -> None:
    """A split run's rank 0: its product FLOPs, collectives and whole
    layers beside their closed forms."""
    pr, co = r["products"], r["collectives"]
    want = pr["closed_form"]
    log(f"phase 10: {label} step {step} on rank 0, product FLOPs outside "
        f"attention (CostMode mm) {pr['mm']:.6e} vs closed form "
        f"{want['layers'] + want['unembed']:.6e} (layers "
        f"{want['layers']:.6e} = one process's / (data x model), "
        f"unembedding {want['unembed']:.6e}; one process "
        f"{want['one_process']:.6e}, ratio "
        f"{want['one_process'] / pr['mm']:.4f}); attention (bmm) "
        f"{pr['bmm']:.6e}; collectives CostMode vs closed form (bytes): "
        + "; ".join(f"{k} {co['costmode_bytes'][k]:.0f} vs "
                    f"{co['closed_form_bytes'][k]:.0f} "
                    f"(x{co['costmode_counts'][k]})" for k in MR_COLLECTIVES)
        + f"; layers computing whole over model: "
        f"{r['whole_layers'] or 'none'}; leaves kept whole over model: "
        f"{r['whole_leaves'] or 'none'}")


def _split_cfg(arch: str, layers, reduced: bool, dtype=None):
    """``arch``'s config (its reduced one when ``reduced``) cut to
    ``layers`` layers (all of them for ``None``), in ``dtype`` when
    given."""
    from repro_torch import configs
    base = configs.get_module(arch).reduced() if reduced \
        else configs.get_config(arch)
    cfg = dataclasses.replace(base, n_layers=layers or base.n_layers)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def split_layers_run(smi: str, work: Path, env: dict, device: str,
                     reduced: bool) -> dict:
    """Phase 10 (f): each of ``MR_SPLIT_LAYERS`` (deepseek-moe-16b's MoE,
    its capacity slots over the data ranks and its experts over model;
    recurrentgemma-9b's RG-LRU channels and its one KV head shared by
    four ranks; falcon-mamba-7b's channels) in bf16 at full width, its
    depth cut, the registry's weights (seed 0), on gloo ranks sharing the
    card, beside one process (a rank of its own) on the same batch; the
    MoE layer alone costed on each rank; deepseek-moe-16b's one process
    run again; ``MR_SPLIT_F32``'s archs in float32 at the same meshes,
    beside a float32 one process; ``MR_SERVE``'s split prefill and decode
    beside one process's, in float32.  The one process, the two ranks and
    the four ranks run one group after another.  Returns what they saw;
    :func:`split_layers_checks` holds it."""
    import torch

    dev_type = "cuda" if device != "cpu" else "cpu"
    rng = np.random.default_rng(10)

    def job(name, cases):
        d = work / name
        d.mkdir()
        return {"init": f"file://{d}/store_{time.monotonic_ns()}",
                "backend": "gloo", "device": device, "work": str(d),
                "reduced": reduced, "cases": cases}

    single, split4, split2, cfgs = [], [], [], {}
    for arch, layers, mesh, b, seq in MR_SPLIT_LAYERS:
        cfg = _split_cfg(arch, layers, reduced)
        cfgs[arch] = cfg
        path = work / f"batch_{arch}.pt"
        torch_save_batch(_train_batch(rng, cfg.vocab, b, seq, "cpu"), path)
        case = {"cfg": dataclasses.asdict(cfg), "seed": 0,
                "batch_file": str(path), "batch": b, "seq": seq,
                "steps": MR_SPLIT_STEPS, "total": MR_SPLIT_STEPS}
        single.append({**case, "kind": "single", "label": arch})
        if arch in MR_SPLIT_REPEAT:
            single.append({**case, "kind": "single", "label": arch + "/again"})
        rank_case = {**case, "kind": "train", "label": arch,
                     "mesh": list(mesh), "moe_cost": arch == MR_MOE}
        group = split4 if mesh[0] * mesh[1] == 4 else split2
        group.append(rank_case)
        if arch in MR_SPLIT_F32:
            b32 = MR_SPLIT_F32[arch]
            cfg32 = _split_cfg(arch, layers, reduced, "float32")
            cfgs[arch + "/f32"] = cfg32
            path = work / f"batch_{arch}_f32.pt"
            torch_save_batch({k: v[:b32] for k, v in torch.load(
                work / f"batch_{arch}.pt", weights_only=False).items()}, path)
            case32 = {**case, "cfg": dataclasses.asdict(cfg32),
                      "batch_file": str(path), "batch": b32}
            single.append({**case32, "kind": "single", "label": arch + "/f32"})
            group.append({**case32, "kind": "train", "label": arch + "/f32",
                          "mesh": list(mesh)})
        if arch in MR_SPLIT_DATA:
            dmesh = MR_SPLIT_DATA[arch]
            (split4 if dmesh[0] * dmesh[1] == 4 else split2).append(
                {**case, "kind": "train", "label": arch + "/data",
                 "mesh": list(dmesh)})
    sarch, smesh, rows, prompt, lens, n_dec, context = MR_SERVE
    slayers = next(n for a, n, *_ in MR_SPLIT_LAYERS if a == sarch)
    scfg = _split_cfg(sarch, slayers, reduced, "float32")
    toks = rng.integers(3, scfg.vocab, (rows, prompt)).astype(np.int32)
    feed = rng.integers(3, scfg.vocab, (rows, n_dec)).astype(np.int32)
    path = work / "serve_inputs.pt"
    torch.save({"tokens": torch.from_numpy(toks),
                "lens": torch.tensor(lens, dtype=torch.int32),
                "feed": torch.from_numpy(feed)}, path)
    serve = {"cfg": dataclasses.asdict(scfg), "seed": 0,
             "batch_file": str(path), "context": context}
    single.append({**serve, "kind": "serve", "label": "serve", "mesh": None})
    split4.append({**serve, "kind": "serve", "label": "serve",
                   "mesh": list(smesh)})
    require(smesh[0] * smesh[1] == 4, "the split serving runs on four ranks")
    held = torch.cuda.memory_reserved() if dev_type == "cuda" else 0
    t0 = time.time()
    # one group at a time: together they would not fit the card's memory
    one = spawn_ranks(1, job("f_one", single), work / "f_one", env)
    two = spawn_ranks(2, job("f_two", split2), work / "f_two", env)
    four = spawn_ranks(4, job("f_four", split4), work / "f_four", env)
    seconds = time.time() - t0
    out = {"seconds": seconds, "archs": {}}

    def gaps(got, want):
        return {key: [abs(g[key] - w[key]) / abs(w[key])
                      for g, w in zip(got, want)]
                for key in ("loss", "grad_norm")}

    def ranks_of(label, m):
        return [r[label] for r in (four if m[0] * m[1] == 4 else two)]

    for arch, layers, mesh, b, seq in MR_SPLIT_LAYERS:
        per = ranks_of(arch, mesh)
        want = one[0][arch]["steps"]
        rel = gaps(per[0]["steps"], want)
        cfg = cfgs[arch]
        yard = {}
        if arch in MR_SPLIT_REPEAT:
            again = one[0][arch + "/again"]["steps"]
            yard["one process again"] = {"steps": again,
                                         "rel": gaps(again, want)}
        if arch in MR_SPLIT_DATA:
            dsteps = ranks_of(arch + "/data", MR_SPLIT_DATA[arch])[0]["steps"]
            yard[f"data axis alone {MR_SPLIT_DATA[arch]}"] = {
                "steps": dsteps, "rel": gaps(dsteps, want)}
        out["archs"][arch] = {"layers": layers, "mesh": list(mesh),
                              "batch": [b, seq], "ranks": per,
                              "one_process": want, "rel": rel,
                              "yardsticks": yard,
                              "held_steps": MR_SPLIT_HELD[arch],
                              "d_model": cfg.d_model, "dtype": cfg.dtype}
        if arch in MR_SPLIT_REPEAT:
            out["archs"][arch]["again"] = again
        log(f"phase 10: (f) {arch} d_model {cfg.d_model} ({cfg.dtype}), cut "
            f"to {layers} layers, at {tuple(mesh)} (gloo ranks on one "
            f"card), {b} x {seq}: losses "
            f"{[x['loss'] for x in per[0]['steps']]} vs one process "
            f"{[x['loss'] for x in want]} (rel "
            f"{[f'{x:.3e}' for x in rel['loss']]}); grad norms "
            f"{[x['grad_norm'] for x in per[0]['steps']]} vs "
            f"{[x['grad_norm'] for x in want]} (rel "
            f"{[f'{x:.3e}' for x in rel['grad_norm']]}); limits "
            f"{MR_BF16_TOL}; step ms {[round(x['ms'], 1) for x in per[0]['steps']]}"
            f" (one process {[round(x['ms'], 1) for x in want]}); resident "
            "bytes = spec shards: " + "; ".join(
                f"{tuple(r['coord'].values())} params "
                f"{r['resident_bytes']['params']} moments "
                f"{r['resident_bytes']['moments']}" for r in per)
            + f"; whole layers {per[0]['whole_layers'] or 'none'}  [{smi}]")
        for name, y in yard.items():
            log(f"phase 10: (f) {arch} yardstick, {name}: losses "
                f"{[x['loss'] for x in y['steps']]}, grad norms "
                f"{[x['grad_norm'] for x in y['steps']]}; rel to one "
                f"process: loss {[f'{x:.3e}' for x in y['rel']['loss']]}, "
                f"grad norm {[f'{x:.3e}' for x in y['rel']['grad_norm']]}; "
                + (f"held equal as floats at steps 1-{MR_SPLIT_STEPS}"
                   if name == "one process again" else
                   f"steps held to {MR_BF16_TOL}: 1-{MR_SPLIT_HELD[arch]}")
                + f"  [{smi}]")
        if arch in MR_SPLIT_F32:
            lab, b32 = arch + "/f32", MR_SPLIT_F32[arch]
            per32, one32 = ranks_of(lab, mesh), one[0][lab]
            rel32 = gaps(per32[0]["steps"], one32["steps"])
            out["archs"][arch]["f32"] = {
                "batch": [b32, seq], "ranks": per32,
                "one_process": one32["steps"], "rel": rel32,
                "params": one32["params"]}
            log(f"phase 10: (f) {arch} in float32, the same {layers} layers "
                f"and widths at {tuple(mesh)}, {b32} x {seq}: "
                f"{one32['params']} parameters, so one process holds "
                f"{one32['params'] * 16 / 1e9:.2f} GB before activations "
                "(weight, gradient and Adam's two moments, 4 bytes each); "
                f"losses {[x['loss'] for x in per32[0]['steps']]} vs one "
                f"process {[x['loss'] for x in one32['steps']]} (rel "
                f"{[f'{x:.3e}' for x in rel32['loss']]}); grad norms "
                f"{[x['grad_norm'] for x in per32[0]['steps']]} vs "
                f"{[x['grad_norm'] for x in one32['steps']]} (rel "
                f"{[f'{x:.3e}' for x in rel32['grad_norm']]}); steps 1-"
                f"{MR_SPLIT_STEPS} held to {MR_SEQ_F32_TOL}; step ms "
                f"{[round(x['ms'], 1) for x in per32[0]['steps']]} (one "
                f"process {[round(x['ms'], 1) for x in one32['steps']]})"
                f"  [{smi}]")
        if arch == MR_MOE:
            mc = per[0]["moe_cost"]
            cf = mc["closed_form"]
            log(f"phase 10: (f) {arch}'s MoE layer alone on rank 0 "
                f"(CostMode, forward and backward, {b // mesh[0]} x {seq} "
                f"tokens a rank): product FLOPs {mc['products']:.6e} vs "
                f"closed form {cf['products']:.6e} (one process "
                f"{cf['one_process']:.6e} on the global batch, ratio "
                f"{cf['one_process'] / mc['products']:.4f}; capacity "
                f"{cf['cap']}, {cf['slots']} slots a data rank); "
                "collectives CostMode vs closed form (bytes): "
                + "; ".join(f"{k} {mc['bytes'][k]:.0f} vs {cf[k]:.0f} "
                            f"(x{mc['counts'][k]})" for k in MR_COLLECTIVES))
    # the split serving against one process, every rank
    want = torch.load(one[0]["serve"]["logits_file"], weights_only=False)
    ranks = [r["serve"] for r in four]
    gaps = []
    for r in ranks:
        got = torch.load(r["logits_file"], weights_only=False)
        gaps.append([{
            "max_abs": float((g - w).abs().max()),
            "excess": float(((g - w).abs() - MR_SERVE_TOL["atol"]
                             - MR_SERVE_TOL["rtol"] * w.abs()).max())}
            for g, w in zip(got, want)])
    out["serve"] = {"arch": sarch, "mesh": list(smesh), "ranks": ranks,
                    "one_process": one[0]["serve"], "gaps": gaps,
                    "d_model": scfg.d_model, "dtype": scfg.dtype}
    kv = ranks[0]["kv"]
    log(f"phase 10: (f) {sarch} serving at {tuple(smesh)} in float32 (d_model "
        f"{scfg.d_model}, {slayers} layers, KV heads {scfg.n_kv_heads} for "
        f"{smesh[1]} ranks), prefill {rows} x {prompt} (lengths {list(lens)})"
        f" + {n_dec} teacher-forced decode steps: logits max |diff| to one "
        f"process per call {[max(g[i]['max_abs'] for g in gaps) for i in range(n_dec + 1)]}"
        f" (excess over {MR_SERVE_TOL}: "
        f"{max(x['excess'] for g in gaps for x in g):.3e}); k/v bytes on "
        f"rank 0 vs state_specs shard: "
        + "; ".join(f"{n} {v[0]} vs {v[1]} {tuple(v[2])}"
                    for n, v in kv.items())
        + f"; one process's k/v "
        f"{sum(v[0] for v in one[0]['serve']['kv'].values())} B; "
        f"{ranks[0]['ms']:.1f} ms on rank 0 (one process "
        f"{one[0]['serve']['ms']:.1f}); whole layers "
        f"{ranks[0]['whole_layers'] or 'none'}  [{smi}]")
    log(f"phase 10: (f) took {seconds:.0f} s, this process holding "
        f"{held / 2**30:.2f} GiB of the card  [{smi}]")
    return out


def split_layers_checks(f: dict, tol: dict) -> None:
    """Holds :func:`split_layers_run`'s results: each arch's ranks agree
    on the loss, its ``MR_SPLIT_HELD`` steps within ``tol`` of one
    process's (the later ones printed beside their yardsticks), resident
    bytes equal to the spec shards, no layer noted whole; the one process
    run again equal as floats; the float32 cases, each rank as above and
    both steps within ``MR_SEQ_F32_TOL``; the MoE's products and
    collectives equal to their closed form on every rank; the split
    serving's logits within ``MR_SERVE_TOL`` of one process's and each k
    and v leaf the bytes of its ``state_specs`` shard on every rank."""
    for arch, a in f["archs"].items():
        per = a["ranks"]
        for r in per:
            require([x["loss"] for x in r["steps"]]
                    == [x["loss"] for x in per[0]["steps"]],
                    "(f) ranks agree on the loss", arch)
            require(r["resident_bytes"] == r["spec_bytes"],
                    "(f) resident bytes = spec shards", arch, r["coord"],
                    r["resident_bytes"], r["spec_bytes"])
            require(r["whole_layers"] == [], "(f) no layer computes whole",
                    arch, r["whole_layers"])
            if "moe_cost" in r:
                mc = r["moe_cost"]
                cf = mc["closed_form"]
                require(mc["products"] == cf["products"],
                        "(f) MoE products = closed form", r["coord"], mc)
                for k in MR_COLLECTIVES:
                    require(mc["bytes"][k] == cf[k],
                            "(f) MoE collectives = closed form", r["coord"],
                            k, mc)
                require(mc["whole_layers"] == [], "(f) MoE split", mc)
        require(len(a["rel"]["loss"]) == MR_SPLIT_STEPS, "(f) steps", arch)
        held = a["held_steps"]
        require(max(a["rel"]["loss"][:held]) <= tol["loss_rel"], "(f) loss",
                arch, a["rel"])
        require(max(a["rel"]["grad_norm"][:held]) <= tol["gnorm_rel"],
                "(f) grad norm", arch, a["rel"])
        if "again" in a:
            metrics = [[(x["loss"], x["grad_norm"]) for x in steps]
                       for steps in (a["one_process"], a["again"])]
            require(metrics[0] == metrics[1] and len(metrics[0])
                    == MR_SPLIT_STEPS, "(f) one process repeats itself bit "
                    "for bit", arch, metrics)
        if "f32" in a:
            f32 = a["f32"]
            for r in f32["ranks"]:
                require([x["loss"] for x in r["steps"]]
                        == [x["loss"] for x in f32["ranks"][0]["steps"]],
                        "(f) float32 ranks agree on the loss", arch)
                require(r["resident_bytes"] == r["spec_bytes"],
                        "(f) float32 resident bytes = spec shards", arch,
                        r["coord"], r["resident_bytes"], r["spec_bytes"])
                require(r["whole_layers"] == [],
                        "(f) float32: no layer computes whole", arch,
                        r["whole_layers"])
            require(len(f32["rel"]["loss"]) == MR_SPLIT_STEPS,
                    "(f) float32 steps", arch)
            require(max(f32["rel"]["loss"]) <= MR_SEQ_F32_TOL["loss_rel"],
                    "(f) float32 loss", arch, f32["rel"])
            require(max(f32["rel"]["grad_norm"])
                    <= MR_SEQ_F32_TOL["gnorm_rel"], "(f) float32 grad norm",
                    arch, f32["rel"])
    sv = f["serve"]
    for r, gaps in zip(sv["ranks"], sv["gaps"]):
        require(all(g["excess"] <= 0 for g in gaps),
                "(f) split serving logits vs one process", gaps)
        require(r["whole_layers"] == [], "(f) serving split",
                r["whole_layers"])
        for n, (got, want, _) in r["kv"].items():
            require(got == want, "(f) k/v bytes = state_specs shard", n,
                    got, want)
            require(got < sv["one_process"]["kv"][n][0],
                    "(f) k/v split", n)


def seqpar_run(smi: str, work: Path, env: dict, device: str,
               reduced: bool) -> dict:
    """Phase 10 (g): the sequence split, fewer rows than data ranks, on
    gloo ranks sharing the card beside one process (a rank of its own),
    the three groups at once.  Training (``MR_SEQ_TRAIN``): each rank runs
    its block of every row's positions; its steps against one process's,
    and under ``CostMode`` its product FLOPs against one process's over
    the data ranks (whisper-tiny's: its encoder's and cross-attention K/V
    projections' whole, :func:`encdec_whole_products`, plus the rest over
    the data ranks) and its collectives against :func:`seq_closed_form`.
    Serving (``MR_SEQ_SERVE``, float32, one row, at each of
    ``MR_SEQ_MESHES``): a prefill split over the data ranks and
    ``MR_SEQ_DECODE`` teacher-forced decode steps on a state whose slots,
    channels and frames they split, against one process's logits; each
    rank's state leaves beside their ``state_specs`` shard.
    :func:`seqpar_checks` holds what it returns."""
    import torch
    from repro_torch import configs

    rng = np.random.default_rng(11)

    def job(name, cases):
        d = work / name
        d.mkdir()
        return {"init": f"file://{d}/store_{time.monotonic_ns()}",
                "backend": "gloo", "device": device, "work": str(d),
                "reduced": reduced, "cases": cases}

    def family(arch):
        return configs.get_module(arch).FAMILY

    def frames(cfg, rows):
        """Stub mel frames of an encoder-decoder (float32, as drawn)."""
        return torch.from_numpy(rng.standard_normal(
            (rows, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))

    single, four, two, cfgs = [], [], [], {}
    for arch, layers, mesh, b, seq, dtype, held in MR_SEQ_TRAIN:
        cfg = _split_cfg(arch, layers, reduced, dtype)
        label = f"train:{arch}:{dtype}"
        cfgs[label] = cfg
        path = work / f"seq_batch_{arch}.pt"
        if not path.exists():
            batch = _train_batch(rng, cfg.vocab, b, seq, "cpu")
            if family(arch) == "encdec":
                batch["frames"] = frames(cfg, b)
            torch_save_batch(batch, path)
        steps = max(held.values())
        case = {"cfg": dataclasses.asdict(cfg), "seed": 0,
                "family": family(arch),
                "batch_file": str(path), "batch": b, "seq": seq,
                "steps": steps, "total": steps, "cost_at": 1}
        single.append({**case, "kind": "single", "label": label})
        (four if mesh[0] * mesh[1] == 4 else two).append(
            {**case, "kind": "train", "label": label, "mesh": list(mesh),
             "seq_cost": True})
    sizes = {}
    for arch, layers, prompt, context in MR_SEQ_SERVE:
        cfg = _split_cfg(arch, layers, reduced, "float32")
        if reduced:     # the rehearsal's window is the reduced config's
            prompt = max(prompt * cfg.d_model // 4096, 32)
            context = max(context * cfg.d_model // 4096, 32)
        cfgs["serve:" + arch], sizes[arch] = cfg, (prompt, context)
        toks = rng.integers(3, cfg.vocab, (1, prompt)).astype(np.int32)
        feed = rng.integers(3, cfg.vocab, (1, MR_SEQ_DECODE)).astype(np.int32)
        path = work / f"seq_serve_{arch}.pt"
        ins = {"tokens": torch.from_numpy(toks),
               "lens": torch.tensor([prompt - 3], dtype=torch.int32),
               "feed": torch.from_numpy(feed)}
        if family(arch) == "encdec":
            ins["frames"] = frames(cfg, 1)
        torch.save(ins, path)
        serve = {"cfg": dataclasses.asdict(cfg), "seed": 0,
                 "family": family(arch),
                 "batch_file": str(path), "context": context,
                 "kind": "serve"}
        single.append({**serve, "label": f"serve:{arch}", "mesh": None})
        for mesh in MR_SEQ_MESHES:
            four.append({**serve, "label": f"serve:{arch}:{mesh[0]}x{mesh[1]}",
                         "mesh": list(mesh)})
    held = torch.cuda.memory_reserved() if device != "cpu" else 0
    t0 = time.time()
    # the three groups at once (small models: the card holds them all)
    ones, ranks4, ranks2 = spawn_groups(
        [(1, job("g_one", single), work / "g_one"),
         (4, job("g_four", four), work / "g_four"),
         (2, job("g_two", two), work / "g_two")], env)
    one = ones[0]
    out = {"seconds": time.time() - t0, "train": {}, "serve": {},
           "held_bytes": held}
    for arch, layers, mesh, b, seq, dtype, held in MR_SEQ_TRAIN:
        label = f"train:{arch}:{dtype}"
        per = [r[label] for r in (ranks4 if mesh[0] * mesh[1] == 4
                                  else ranks2)]
        want = one[label]
        rel = {k: [abs(g[k] - w[k]) / abs(w[k]) for g, w in
                   zip(per[0]["steps"], want["steps"])]
               for k in ("loss", "grad_norm")}
        n = mesh[0]
        cfg = cfgs[label]
        tol = MR_BF16_TOL if dtype == "bfloat16" else MR_SEQ_F32_TOL
        # what every rank computes whole: an encoder-decoder's encoder and
        # cross-attention K/V projections (the card's bf16 products are
        # common._Mm32, the rest aten mm)
        whole = encdec_whole_products(
            cfg, b, dtype != "bfloat16" or device == "cpu") \
            if family(arch) == "encdec" else 0.0
        out["train"][label] = {"mesh": list(mesh), "batch": [b, seq],
                               "layers": cfg.n_layers, "ranks": per,
                               "one_process": want, "rel": rel,
                               "held": held, "tol": tol,
                               "whole_products": whole}
        co = per[0]["collectives"]
        log(f"phase 10: (g) {arch} d_model {cfg.d_model} ({cfg.dtype}), "
            f"{cfg.n_layers} layers, at {tuple(mesh)} (gloo ranks on one "
            f"card), {b} x {seq}: {seq // n} positions a rank; losses "
            f"{[x['loss'] for x in per[0]['steps']]} vs one process "
            f"{[x['loss'] for x in want['steps']]} (rel "
            f"{[f'{x:.3e}' for x in rel['loss']]}); grad norms "
            f"{[x['grad_norm'] for x in per[0]['steps']]} vs "
            f"{[x['grad_norm'] for x in want['steps']]} (rel "
            f"{[f'{x:.3e}' for x in rel['grad_norm']]}); limits "
            f"{tol}, steps held {held}; step-1 product FLOPs on rank 0 "
            f"{per[0]['products_all']:.6e} vs whole {whole:.6e} + (one "
            f"process's - whole) / {n} "
            f"{whole + (want['products_all'] - whole) / n:.6e}; "
            "collectives CostMode vs "
            "closed form (bytes): " + "; ".join(
                f"{k} {co['costmode_bytes'][k]:.0f} vs "
                f"{co['closed_form_bytes'][k]:.0f} "
                f"(x{co['costmode_counts'][k]})" for k in MR_COLLECTIVES)
            + f"; step ms {[round(x['ms'], 1) for x in per[0]['steps']]} "
            f"(one process {[round(x['ms'], 1) for x in want['steps']]}); "
            f"whole {per[0]['whole_layers'] or 'none'}  [{smi}]")
    for arch, *_ in MR_SEQ_SERVE:
        cfg, (prompt, context) = cfgs["serve:" + arch], sizes[arch]
        base = one[f"serve:{arch}"]
        want = torch.load(base["logits_file"], weights_only=False)
        for mesh in MR_SEQ_MESHES:
            label = f"serve:{arch}:{mesh[0]}x{mesh[1]}"
            per = [r[label] for r in ranks4]
            gaps = []
            for r in per:
                got = torch.load(r["logits_file"], weights_only=False)
                gaps.append([{
                    "max_abs": float((g - w).abs().max()),
                    "excess": float(((g - w).abs() - MR_SERVE_TOL["atol"]
                                     - MR_SERVE_TOL["rtol"] * w.abs()).max())}
                    for g, w in zip(got, want)])
            out["serve"][label] = {"arch": arch, "mesh": list(mesh),
                                   "vocab": cfg.vocab,
                                   "ranks": per, "one_process": base,
                                   "gaps": gaps, "d_model": cfg.d_model,
                                   "layers": cfg.n_layers}
            worst = max(x["max_abs"] for g in gaps for x in g)
            log(f"phase 10: (g) {arch} serving at {tuple(mesh)} in float32 "
                f"(d_model {cfg.d_model}, {cfg.n_layers} layers, KV heads "
                f"{cfg.n_kv_heads}), one row: prefill {prompt} (length "
                f"{prompt if family(arch) == 'encdec' else prompt - 3}, "
                f"context {context}) split over the data "
                f"ranks + {MR_SEQ_DECODE} teacher-forced decode steps: logits "
                f"max |diff| to one process {worst:.3e} (bound "
                f"{MR_SERVE_TOL}; excess "
                f"{max(x['excess'] for g in gaps for x in g):.3e}); state "
                "bytes a rank vs state_specs shard: " + "; ".join(
                    f"rank {i} " + ", ".join(f"{nm} {v[0]} vs {v[1]}"
                                             for nm, v in r["leaves"].items())
                    for i, r in enumerate(per))
                + f"; one process's state "
                f"{sum(v[0] for v in base['leaves'].values())} B; "
                f"{per[0]['ms']:.1f} ms on rank 0 (one process "
                f"{base['ms']:.1f}); whole {per[0]['whole_layers'] or 'none'}"
                f"  [{smi}]")
    log(f"phase 10: (g) took {out['seconds']:.0f} s  [{smi}]")
    return out


def seqpar_checks(g: dict) -> None:
    """Holds :func:`seqpar_run`'s results: each training run's ranks
    agree on the loss, its held steps of each metric are within its
    dtype's tolerance of one process's (``MR_SEQ_TRAIN``), its rank's
    product FLOPs are what it computes whole (an encoder-decoder's
    encoder and cross-attention K/V projections) plus the rest of one
    process's over the data ranks, its collectives' bytes their closed
    form, nothing computes whole; each split serving's logits are within
    ``MR_SERVE_TOL`` of one process's on every rank, each k/v, position
    and cross-attention K/V leaf the bytes of its ``state_specs`` shard,
    the recurrent states no more than theirs, nothing whole but a
    vocabulary that does not divide the model axis (its table whole, as
    the reference's ``leaf_spec`` keeps it)."""
    for arch, a in g["train"].items():
        per = a["ranks"]
        n = a["mesh"][0]
        whole = a["whole_products"]
        for r in per:
            require([x["loss"] for x in r["steps"]]
                    == [x["loss"] for x in per[0]["steps"]],
                    "(g) ranks agree on the loss", arch)
            require(r["whole_layers"] == [], "(g) nothing computes whole",
                    arch, r["whole_layers"])
            want = whole + (a["one_process"]["products_all"] - whole) / n
            require(abs(r["products_all"] - want) <= 1e-9 * want,
                    "(g) rank products = whole + one process's rest / data "
                    "ranks", arch, r["products_all"], want)
            co = r["collectives"]
            for k in MR_COLLECTIVES:
                require(co["costmode_bytes"][k] == co["closed_form_bytes"][k],
                        "(g) collectives = closed form", arch, k, co)
        held, tol = a["held"], a["tol"]
        require(max(a["rel"]["loss"][:held["loss"]], default=0)
                <= tol["loss_rel"], "(g) loss", arch, a["rel"])
        require(max(a["rel"]["grad_norm"][:held["grad_norm"]], default=0)
                <= tol["gnorm_rel"], "(g) grad norm", arch, a["rel"])
    for label, sv in g["serve"].items():
        whole_vocab = sv["vocab"] % sv["mesh"][1] != 0
        for r, gaps in zip(sv["ranks"], sv["gaps"]):
            require(all(x["excess"] <= 0 for x in gaps),
                    "(g) split serving logits vs one process", label, gaps)
            require([w for w in r["whole_layers"] if not (
                whole_vocab and w[0] == "embedding")] == [],
                "(g) serving split", label, r["whole_layers"])
            for nm, (got, want, _) in r["leaves"].items():
                if nm.endswith((".k", ".v", ".pos", "cursor")) \
                        or nm.startswith("enc_kv."):
                    require(got == want, "(g) state bytes = state_specs "
                            "shard", label, nm, got, want)
                else:
                    require(got <= want, "(g) recurrent state within its "
                            "state_specs shard", label, nm, got, want)


def multirank_phase(smi: str, work: Path, device="cuda",
                    reduced: bool = False, backend1: str = "nccl",
                    danube=None) -> dict:
    """Phase 10, multi-rank training (``train.sharding``, the launcher
    under ``torch.distributed.run``, the model axis's compute split), on
    bytelm-100m at its published config and the launcher's 8 x 512
    global batch, and on h2o-danube-1.8b at phase 8's; ``reduced`` and
    ``backend1`` (gloo for the world of one) rehearse it on the CPU.
    ``danube``: phase 8's ``{"cfg", "seed", "batch", "steps"}`` (its
    config, model seed, batch and step metrics), or ``None`` to skip (e).

      (a) World 1 under NCCL, mesh (1, 1), through the launcher: 3 steps
          against the single-process launcher's 3 (phase 8's path) on the
          same batches: the metrics and the step-3 checkpoints (every
          parameter and moment) byte for byte.
      (b) World 4 under gloo, all four ranks on the one card, meshes
          (2, 2), (4, 1) and (1, 4), from the launcher's weights: each
          step's loss and grad norm, and the step-3 parameters, within
          ``MR_BF16_TOL`` of (a); each rank's resident parameter and
          moment bytes equal to its spec shards; each rank's pipeline
          launches; a step split into gathers, forward and backward,
          model-axis reductions, data reductions and update.  With a
          model axis, (2, 2) and (1, 4): the last step's product FLOPs
          (``mm``) equal to ``rank_products`` (÷ data x model, the
          unembedding of the 259-byte vocabulary ÷ data), its
          collectives' bytes by kind under ``CostMode`` equal to
          ``collective_closed_form`` (Megatron's f and g included), the
          layers and leaves that stayed whole, and why.
      (c) Elastic: the (2, 2) run checkpoints at step 2 and runs on to
          step 4; ``plan_remesh((2, 2), 1, 8)`` gives (1, 2) with 2
          microbatches; two ranks resume the step-2 checkpoint through the
          launcher with that plan and take steps 3-4, their losses within
          ``MR_ELASTIC_REL`` of the four-rank run's.
      (d) ``hierarchical_grad_sync`` at (pod 2, data 2) on the arch's
          gradient shapes: within 0.02 of a plain float32 all-reduce; the
          pod hop's payload a quarter of the float32 hop's.
      (e) h2o-danube-1.8b at full width and depth on two gloo ranks at
          (1, 2) (16 heads, 4 KV heads, 3,456 hidden units and 16,000
          vocabulary rows a rank: the vocab-parallel embedding and CE),
          phase 8's weights and batch, 2 steps: losses and grad norms
          within ``MR_BF16_TOL`` of phase 8's steps 1-2; the product
          FLOPs, collectives and bytes held as in (b).
      (f) The split MoE, RG-LRU and Mamba in bf16
          (:func:`split_layers_run`): deepseek-moe-16b at (2, 2),
          recurrentgemma-9b at (1, 4) and falcon-mamba-7b at (1, 2), full
          width, depth cut, ``MR_SPLIT_HELD`` steps within
          ``MR_BF16_TOL`` of one process's; deepseek-moe-16b's one
          process run twice, bit for bit; deepseek-moe-16b and
          falcon-mamba-7b in float32 (``MR_SPLIT_F32``), steps 1-2
          within ``MR_SEQ_F32_TOL``; the MoE's products and collectives
          against their
          closed form; recurrentgemma-9b's split serving at (1, 4)
          against one process's logits (float32, ``MR_SERVE_TOL``) and
          its k/v bytes against their ``state_specs`` shard.
      (g) The sequence split (:func:`seqpar_run`, :func:`seqpar_checks`).
    Times beside the card's name and power limit; those of gloo ranks
    sharing one card are a correctness run's, not a speed figure."""
    import shutil

    from repro_torch.launch import elastic

    t_phase = time.time()
    # one hash salt for every process: the synthetic corpus salts its
    # seed with hash(lang), so ranks draw a single process's documents
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               PYTHONHASHSEED="0")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    dev_type = "cuda" if device != "cpu" else "cpu"
    red = ["--reduced"] if reduced else []
    base = ["--arch", TRAIN_ARCH, *red, "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--device", dev_type,
            "--log-every", "1"]
    out = {}

    # (a) the single-process launcher, then world 1 under NCCL
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *base, "--steps",
         str(MR_STEPS), "--ckpt-every", str(MR_STEPS), "--ckpt-dir",
         str(work / "a1"), "--metrics", str(work / "a1.jsonl")],
        capture_output=True, text=True, env=env, cwd=str(ROOT),
        timeout=MR_TIMEOUT)
    require(proc.returncode == 0, "single-process launcher",
            proc.stderr[-3000:])
    single_s = time.time() - t0
    t0 = time.time()
    log_w1 = torchrun(1, [*base, "--steps", str(MR_STEPS), "--ckpt-every",
                          str(MR_STEPS), "--ckpt-dir", str(work / "w1"),
                          "--backend", backend1, "--metrics",
                          str(work / "w1.jsonl")], env)
    w1_s = time.time() - t0
    m_single, m_w1 = _metrics(work / "a1.jsonl"), _metrics(work / "w1.jsonl")
    require(f"mesh: {{'data': 1, 'model': 1}}" in log_w1, "world 1 mesh",
            log_w1[-500:])
    require(m_w1 == m_single, "world 1 metrics vs single process", m_w1,
            m_single)
    d1, d2 = work / "a1" / f"step_{MR_STEPS}", work / "w1" / f"step_{MR_STEPS}"
    names = sorted(os.listdir(d1))
    require(sorted(os.listdir(d2)) == names, "world 1 checkpoint files")
    import filecmp
    same = [n for n in names if filecmp.cmp(d1 / n, d2 / n, shallow=False)]
    require(len(same) == len(names), "world 1 checkpoint bit-equal",
            sorted(set(names) - set(same))[:10])
    out["world1"] = {"backend": backend1, "metrics": m_w1,
                     "single_metrics": m_single, "bit_equal": True,
                     "files": len(names), "single_s": single_s,
                     "torchrun_s": w1_s}
    log(f"phase 10: (a) world 1 under {backend1}, mesh (1, 1), through "
        f"torch.distributed.run: {MR_STEPS} steps bit-equal to the single-"
        f"process launcher (losses {[m['loss'] for m in m_w1]}, grad norms "
        f"{[m['grad_norm'] for m in m_w1]}; all {len(names)} checkpoint files "
        f"of step {MR_STEPS} byte-identical); {w1_s:.1f} s with the process "
        f"start  [{smi}]")

    # (b)-(d): four gloo ranks on the one card
    job = {"init": f"file://{work}/store_{time.monotonic_ns()}",
           "backend": "gloo", "device": device, "work": str(work),
           "arch": TRAIN_ARCH, "reduced": reduced, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "cases": [
               {"kind": "train", "label": "2x2", "mesh": [2, 2],
                "steps": MR_TOTAL, "total": MR_TOTAL,
                "compare_at": MR_STEPS, "a_ckpt": str(work / "a1"),
                "save_at": MR_SAVE_AT, "ckpt_dir": str(work / "c22"),
                "time_at": MR_STEPS, "cost_at": MR_TOTAL},
               {"kind": "train", "label": "4x1", "mesh": [4, 1],
                "steps": MR_STEPS, "total": MR_STEPS,
                "compare_at": MR_STEPS, "a_ckpt": str(work / "a1"),
                "time_at": MR_STEPS},
               {"kind": "train", "label": "1x4", "mesh": [1, 4],
                "steps": MR_TOTAL, "total": MR_TOTAL,
                "compare_at": MR_STEPS, "a_ckpt": str(work / "a1"),
                "time_at": MR_STEPS, "cost_at": MR_TOTAL},
               {"kind": "sync", "label": "sync"}]}
    t0 = time.time()
    ranks = spawn_ranks(4, job, work, env)
    four_s = time.time() - t0
    tol = MR_BF16_TOL
    for label in ("2x2", "4x1", "1x4"):
        per = [r[label] for r in ranks]
        steps0 = per[0]["steps"]
        for r in per[1:]:
            require([s["loss"] for s in r["steps"]] == [
                s["loss"] for s in steps0], "ranks agree on the loss", label)
        rel = {"loss": [], "grad_norm": []}
        for k in range(MR_STEPS):
            for key in rel:
                g, w = steps0[k][key], m_single[k][key]
                rel[key].append(abs(g - w) / abs(w))
                require(steps0[k]["lr"] == m_single[k]["lr"], "lr", label, k)
        vs = per[0]["vs_a"]
        for r in per:
            require(r["resident_bytes"] == r["spec_bytes"],
                    "resident bytes = spec shards", label, r["coord"],
                    r["resident_bytes"], r["spec_bytes"])
        out[label] = {"ranks": per, "rel_vs_a": rel, "vs_a": vs}
        log(f"phase 10: (b) {label} gloo x4 on one card: losses "
            f"{[round(s['loss'], 6) for s in steps0]}, rel to (a) "
            f"{[f'{x:.2e}' for x in rel['loss']]}; grad norm rel "
            f"{[f'{x:.2e}' for x in rel['grad_norm']]}; step-{MR_STEPS} "
            f"parameters max |diff| {vs['param_max_abs_diff']:.3g}, excess "
            f"over {MR_PARAM_BOUND} {vs['param_excess_over_bound']:.3g}; "
            "resident bytes = spec shards on every rank: "
            + "; ".join(f"{tuple(r['coord'].values())} params "
                        f"{r['resident_bytes']['params']} moments "
                        f"{r['resident_bytes']['moments']}" for r in per)
            + "; pipeline launches per rank: "
            + "; ".join(str({k: v for k, v in r["launches"].items() if v})
                        for r in per))
        _log_split(label, MR_STEPS, per[0]["split_ms"], smi)
    for label in MR_SPLIT:
        _log_model_axis(label, MR_TOTAL, out[label]["ranks"][0])

    # (c) elastic: two ranks resume the (2, 2) run's step-2 checkpoint
    plan = elastic.plan_remesh((2, 2), failed_chips=1,
                               global_batch=TRAIN_BATCH)
    require((plan.data, plan.model, plan.n_micro) == (1, 2, 2), "plan",
            vars(plan))
    (work / "el").mkdir()
    shutil.copytree(work / "c22" / f"step_{MR_SAVE_AT}",
                    work / "el" / f"step_{MR_SAVE_AT}")
    t0 = time.time()
    log_el = torchrun(plan.data * plan.model,
                      [*base, "--steps", str(MR_TOTAL), "--ckpt-every",
                       "1000", "--ckpt-dir", str(work / "el"), "--resume",
                       "--micro", str(plan.n_micro), "--backend", "gloo",
                       "--metrics", str(work / "el.jsonl")], env)
    el_s = time.time() - t0
    m_el = _metrics(work / "el.jsonl")
    want = out["2x2"]["ranks"][0]["steps"][MR_SAVE_AT:]
    require(f"resumed from step {MR_SAVE_AT}" in log_el
            and "mesh: {'data': 1, 'model': 2}" in log_el, "elastic log",
            log_el[-800:])
    require([m["step"] for m in m_el] == list(range(MR_SAVE_AT + 1,
                                                    MR_TOTAL + 1)),
            "elastic steps", m_el)
    el_rel = [abs(g["loss"] - w["loss"]) / abs(w["loss"])
              for g, w in zip(m_el, want)]
    out["elastic"] = {"plan": vars(plan), "metrics": m_el,
                      "four_rank": want, "loss_rel": el_rel, "s": el_s}
    log(f"phase 10: (c) elastic: (2, 2) checkpoint at step {MR_SAVE_AT}, "
        f"plan_remesh -> data {plan.data} model {plan.model} n_micro "
        f"{plan.n_micro}; two ranks resumed through the launcher, steps "
        f"{MR_SAVE_AT + 1}-{MR_TOTAL} losses "
        f"{[round(m['loss'], 6) for m in m_el]} vs four ranks "
        f"{[round(w['loss'], 6) for w in want]} (rel "
        f"{[f'{x:.2e}' for x in el_rel]})")

    # (d) the hierarchical sync
    sy = [r["sync"] for r in ranks]
    out["sync"] = sy
    log(f"phase 10: (d) hierarchical_grad_sync (pod 2, data 2) on "
        f"{TRAIN_ARCH}'s gradient shapes: max relative error to the plain "
        f"f32 all-reduce {max(s['max_rel_err'] for s in sy):.4f} (< 0.02); "
        f"pod hop per rank: int8 payload {sy[0]['pod_hop_int8_payload']} B "
        f"vs f32 {sy[0]['pod_hop_f32_payload']} B (CostMode, outputs: int8 "
        f"all-gather {sy[0]['pod_hop_int8_bytes']:.0f} B vs f32 all-reduce "
        f"{sy[0]['pod_hop_f32_bytes']:.0f} B); sync {sy[0]['int8']['ms']:.0f}"
        f" ms int8, {sy[0]['f32']['ms']:.0f} ms f32 (gloo, one card: a "
        f"correctness run)  [{smi}]")
    out["four_rank_s"] = four_s

    # (e) h2o-danube-1.8b at (1, 2)
    if danube is not None:
        torch_save_batch(danube["batch"], work / "danube_batch.pt")
        djob = {"init": f"file://{work}/store_{time.monotonic_ns()}",
                "backend": "gloo", "device": device, "work": str(work),
                "arch": danube["cfg"].name, "reduced": False,
                "cfg": dataclasses.asdict(danube["cfg"]),
                "seed": danube["seed"],
                "batch_file": str(work / "danube_batch.pt"),
                "batch": danube["batch"]["tokens"].shape[0],
                "seq": danube["batch"]["tokens"].shape[1], "cases": [
                    {"kind": "train", "label": "danube", "mesh": [1, 2],
                     "steps": MR_DANUBE_STEPS, "total": DANUBE_STEPS,
                     "time_at": 1, "cost_at": MR_DANUBE_STEPS}]}
        t0 = time.time()
        dranks = spawn_ranks(2, djob, work, env)
        d_s = time.time() - t0
        per = [r["danube"] for r in dranks]
        want = danube["steps"][:MR_DANUBE_STEPS]
        rel = {key: [abs(g[key] - w[key]) / abs(w[key])
                     for g, w in zip(per[0]["steps"], want)]
               for key in ("loss", "grad_norm")}
        for r in per:
            require([x["loss"] for x in r["steps"]]
                    == [x["loss"] for x in per[0]["steps"]],
                    "danube ranks agree on the loss")
            require(r["resident_bytes"] == r["spec_bytes"],
                    "danube resident bytes = spec shards", r["coord"],
                    r["resident_bytes"], r["spec_bytes"])
        out["danube"] = {"ranks": per, "rel_vs_phase8": rel,
                         "phase8": want, "s": d_s}
        log(f"phase 10: (e) {danube['cfg'].name} full width and depth at "
            f"(1, 2), gloo x2 on one card, phase 8's weights and 1 x "
            f"{djob['seq']} batch: losses "
            f"{[round(x['loss'], 6) for x in per[0]['steps']]} vs phase 8 "
            f"{[round(x['loss'], 6) for x in want]} (rel "
            f"{[f'{x:.2e}' for x in rel['loss']]}); grad norm rel "
            f"{[f'{x:.2e}' for x in rel['grad_norm']]}; step ms "
            f"{[round(x['ms'], 1) for x in per[0]['steps']]} (phase 8 one "
            f"process {[round(x['ms'], 1) for x in want]}); resident bytes = "
            "spec shards: " + "; ".join(
                f"{tuple(r['coord'].values())} params "
                f"{r['resident_bytes']['params']} moments "
                f"{r['resident_bytes']['moments']}" for r in per)
            + f"  [{smi}]")
        _log_split("danube 1x2", 1, per[0]["split_ms"], smi)
        _log_model_axis("danube 1x2", MR_DANUBE_STEPS, per[0])
    # (f) the split MoE, RG-LRU and Mamba in bf16
    out["split_layers"] = split_layers_run(smi, work, env, device, reduced)
    # (g) the sequence split
    out["seqpar"] = seqpar_run(smi, work, env, device, reduced)
    out["seconds"] = time.time() - t_phase

    # the checks with tolerances, after every number is printed
    for label in ("2x2", "4x1", "1x4"):
        rel, vs = out[label]["rel_vs_a"], out[label]["vs_a"]
        require(max(rel["loss"]) <= tol["loss_rel"], "loss vs (a)", label,
                rel["loss"])
        require(max(rel["grad_norm"]) <= tol["gnorm_rel"],
                "grad norm vs (a)", label, rel["grad_norm"])
        require(vs["param_excess_over_bound"] <= 0, "parameters vs (a)",
                label, vs)
        # one ronepass launch a rank and step (the plain version on the CPU)
        launches = [r["launches"] for r in out[label]["ranks"]]
        require(all(lc["ronepass"] == (len(r["steps"]) if dev_type == "cuda"
                                       else 0) for lc, r in zip(
            launches, out[label]["ranks"])),
            "one ronepass launch a rank and step", label, launches)
    split = [out[label]["ranks"] for label in MR_SPLIT]
    if danube is not None:
        split.append(out["danube"]["ranks"])
        for key, lim in (("loss", tol["loss_rel"]),
                         ("grad_norm", tol["gnorm_rel"])):
            require(max(out["danube"]["rel_vs_phase8"][key]) <= lim,
                    f"danube {key} vs phase 8",
                    out["danube"]["rel_vs_phase8"])
    for per in split:
        for r in per:
            pr, co = r["products"], r["collectives"]
            want = pr["closed_form"]
            # on the CPU (a rehearsal) aten's products save their inputs
            # before they run, so the remat recompute stops before each
            # layer's last product: the card's form holds on the card
            require(pr["mm"] == want["layers"] + want["unembed"]
                    or dev_type == "cpu",
                    "rank products = closed form", r["coord"], pr)
            for k in MR_COLLECTIVES:
                require(co["costmode_bytes"][k] == co["closed_form_bytes"][k],
                        "collectives = closed form", r["coord"], k, co)
    require(max(el_rel) <= MR_ELASTIC_REL, "elastic losses", el_rel)
    for s in sy:
        require(s["max_rel_err"] < 0.02, "sync error", s["max_rel_err"])
        require(s["pod_hop_int8_payload"] * 4 == s["pod_hop_f32_payload"],
                "pod hop payload", s)
        require(s["pod_hop_int8_bytes"] * 2 == s["pod_hop_f32_bytes"],
                "pod hop bytes (CostMode)", s)
    split_layers_checks(out["split_layers"], tol)
    seqpar_checks(out["seqpar"])
    log(f"phase 10: took {out['seconds']:.0f} s (four ranks "
        f"{four_s:.0f} s, elastic {el_s:.0f} s, (f) "
        f"{out['split_layers']['seconds']:.0f} s, (g) "
        f"{out['seqpar']['seconds']:.0f} s)  [{smi}]")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "chip_smoke.json"))
    ap.add_argument("--rank-job", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_job:                  # one rank of phase 10
        return rank_job(args.rank_job)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    try:
        if inputs is None:
            raise ImportError("tools/inputs.py or src/repro_torch")
        import repro_torch
        from repro_torch.core import compaction, packing
        from repro_torch.core import transcode as tc
        from repro_torch.core import utf8 as u8mod, utf16 as u16mod
        from repro_torch.core import windowed as win
        from repro_torch.data import pipeline as dp
        from repro_torch.kernels import _build, ops
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import fused_transcode as ft
        from repro_torch.kernels import onepass_transcode as op
        from repro_torch.kernels import ragged_transcode as rt
        from repro_torch.kernels import stages
        from repro_torch.kernels import utf8_decode as kdec
        from repro_torch.kernels import utf8_validate as kval
        from repro_torch.kernels import utf16_encode as kenc
        from repro_torch.models import registry  # noqa: F401  (phase 5)
        from repro_torch.testing import faults
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package or tools/inputs.py is "
              f"missing ({exc}); "
              f"run from the root of a checkout", file=sys.stderr)
        return 3

    t_start = time.time()
    report = {"seed": args.seed}
    rng = np.random.default_rng(args.seed)
    # The legacy-ops and tile-class inputs draw from generators of their
    # own, so the other paths' data stay those of --seed alone.
    legacy_rng = np.random.default_rng([args.seed, 1])
    class_rng = np.random.default_rng([args.seed, 2])

    # -- 1. device and build -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    report["card"] = card
    t0 = time.time()
    lib_path = _build.build()
    report["build_s"] = time.time() - t0
    report["nvcc_log"] = str(lib_path.parent / "nvcc.log")
    report["source_digest"] = lib_path.parent.name
    log(f"phase 1: kernels built in {report['build_s']:.1f} s ({lib_path}; "
        f"source digest {lib_path.parent.name})")
    kernels = {"count": ft.count_kernel, "write": ft.write_kernel,
               "onepass": op.onepass_kernel, "rcount": rt.rcount_kernel,
               "rwrite": rt.rwrite_kernel, "ronepass": rt.ronepass_kernel,
               "validate": kval.validate_kernel, "decode": kdec.decode_kernel,
               "encode": kenc.encode_kernel, "flash": fa.flash_kernel,
               "windowed_utf8": win.windowed_utf8_kernel,
               "windowed_utf16": win.windowed_utf16_kernel}
    walks = {"utf8": (win.windowed_utf8_kernel, win.windowed_utf8_plain,
                      u8mod.first_error_index),
             "utf16": (win.windowed_utf16_kernel, win.windowed_utf16_plain,
                       u16mod.first_error_index)}
    max_err = {name: 0 for name in kernels}

    def zero_counts():
        for kern in kernels.values():
            kern.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {name: kern.launches for name, kern in kernels.items()
                if kern.launches}

    def hold_repeats(name, launch, want, *ctx):
        """``REPEATS - 1`` more launches of a one-pass kernel, each
        bit-identical to its first (``want``, already held to plain)."""
        for rep in range(1, REPEATS):
            hold(name, launch(), want, max_err, *ctx, "launch", rep)

    def hold_kernels(x, n, cap, src, dst, errors, validate, *ctx,
                     repeats=False):
        """Each kernel against its plain version on one input, the
        one-pass kernel ``REPEATS`` times when ``repeats``; returns the
        onepass kernel's ``(buffer, fin)``."""
        kw = dict(src=src, dst=dst, errors=errors)
        k_cnt = ft.count_kernel(x, n, validate=validate, **kw)
        hold("count", k_cnt, ft.count_plain(x, n, validate=validate, **kw),
             max_err, *ctx)
        base, _total = compaction.tile_base_offsets(k_cnt[0])
        hold("write", ft.write_kernel(x, n, base, cap, **kw),
             ft.write_plain(x, n, base, cap, **kw), max_err, *ctx)
        k_o = op.onepass_kernel(x, n, cap, validate=validate, **kw)
        hold("onepass", k_o, op.onepass_plain(x, n, cap, validate=validate,
                                              **kw), max_err, *ctx)
        if repeats:
            hold_repeats("onepass", lambda: op.onepass_kernel(
                x, n, cap, validate=validate, **kw), k_o, *ctx)
        return k_o

    def general_count(x, src, dst, errors, validate, n=None, own=None):
        """Per-tile ``(total, err, first_err)`` of the general lane body
        on every tile (``stages.count_tile``), with no tile-class
        dispatch: a yardstick for the count kernels that does not share
        their class decision.  ``own`` for a packed batch, else ``n``."""
        codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
        if own is None:
            t, tp, tn, gidx = stages.tiles(x, n)
            live = gidx < n
        else:
            t, tp, tn, gidx = stages.ragged_tiles(x, *own[1:])
            live = gidx < own[1][:, None]
        return stages.count_tile(codec_s, codec_d, t, tp, tn, live, gidx,
                                 ft.validation_tables(codec_s, x.device),
                                 errors=errors, validate=validate)

    def general_write(x, base, cap, src, dst, errors, n=None, own=None):
        """The write pass through the general lane body on every tile
        (``stages.write_stage``), with no tile-class dispatch: a
        yardstick for the write kernels that does not share their class
        decision.  ``own`` for a packed batch, else ``n``."""
        codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
        if own is None:
            t, tp, tn, gidx = stages.tiles(x, n)
            live = gidx < n
        else:
            t, tp, tn, gidx = stages.ragged_tiles(x, *own[1:])
            live = gidx < own[1][:, None]
        eff, planes = stages.write_stage(codec_s, codec_d, t, tp, tn, live,
                                         errors=errors)
        return stages.place_units(eff, planes, base, cap).to(codec_d.dtype)

    def hold_legacy(x, n, fmt, *ctx):
        """The legacy kernels of one format against their plain versions
        on one input, narrow and widened to int32."""
        for xx in (x, x.to(torch.int32)):
            if fmt == "utf8":
                hold("validate", kval.validate_kernel(xx, n),
                     kval.validate_plain(xx, n), max_err, *ctx, xx.dtype)
                hold("decode", kdec.decode_kernel(xx, n),
                     kdec.decode_plain(xx, n), max_err, *ctx, xx.dtype)
            else:
                hold("encode", kenc.encode_kernel(xx, n),
                     kenc.encode_plain(xx, n), max_err, *ctx, xx.dtype)

    def ownership(x, offsets, lengths):
        """``(own, cap factor * nblk * 1024)`` of a packed batch on the
        card."""
        nblk = max(1, -(-x.shape[0] // BLOCK))
        own = packing.tile_ownership(torch.from_numpy(offsets).cuda(),
                                     torch.from_numpy(lengths).cuda(), nblk)
        return own, nblk * BLOCK

    def hold_ragged(x, offsets, lengths, src, dst, errors, validate, *ctx,
                    repeats=False):
        """Each ragged kernel against its plain version on one packed
        batch, the one-pass kernel ``REPEATS`` times when ``repeats``;
        returns the ragged onepass kernel's outputs."""
        own, span = ownership(x, offsets, lengths)
        cap = tc.CAP_FACTOR[(src, dst)] * span
        kw = dict(src=src, dst=dst, errors=errors)
        k_cnt = rt.rcount_kernel(x, own, validate=validate, **kw)
        hold("rcount", k_cnt, rt.rcount_plain(x, own, validate=validate,
                                              **kw), max_err, *ctx)
        base, _total = compaction.tile_base_offsets(k_cnt[0])
        hold("rwrite", rt.rwrite_kernel(x, own, base, cap, **kw),
             rt.rwrite_plain(x, own, base, cap, **kw), max_err, *ctx)
        k_o = rt.ronepass_kernel(x, own, cap, validate=validate, **kw)
        hold("ronepass", k_o, rt.ronepass_plain(x, own, cap,
                                                validate=validate, **kw),
             max_err, *ctx)
        if repeats:
            hold_repeats("ronepass", lambda: rt.ronepass_kernel(
                x, own, cap, validate=validate, **kw), k_o, *ctx)
        return k_o

    def same_as_single(res, docs, src, dst, errors, validate, which, *ctx):
        """Every document ``d in which`` of a ragged result, split out by
        ``unpack_results``, equals the single-buffer ``transcode`` of that
        document alone, on the card (the buffers up to both capacities)."""
        parts = packing.unpack_results(res.buffer, res.offsets, res.counts)
        counts, statuses = res.counts.cpu().numpy(), res.statuses.cpu().numpy()
        for d in which:
            doc = docs[d]
            n = len(doc)
            buf = np.zeros(max(n, 1), NP_DTYPE[src])
            buf[:n] = doc
            one = repro_torch.transcode(torch.from_numpy(buf).cuda(), dst,
                                        src_format=src, n_valid=n,
                                        errors=errors, validate=validate)
            require(int(counts[d]) == int(one.count)
                    and int(statuses[d]) == int(one.status),
                    "ragged vs single count/status", d, *ctx)
            k = min(len(parts[d]), one.buffer.shape[0])
            require(np.array_equal(parts[d][:k],
                                   one.buffer[:k].cpu().numpy()),
                    "ragged vs single buffer", d, *ctx)

    # -- 2. correctness on the card ------------------------------------------
    text_cps = np.concatenate([inputs.codepoints(lang, TEXT_CHARS, rng)
                               for lang in inputs.PROFILES])
    for fmt in ("utf8", "utf16"):
        require(np.array_equal(
            encode(text_cps, fmt),
            np.frombuffer("".join(map(chr, text_cps)).encode(PY_CODEC[fmt]),
                          NP_DTYPE[fmt])), "numpy encoder", fmt)
    one_inputs = {fmt: correctness_inputs(fmt, text_cps, rng)
              for fmt in PY_CODEC}
    n_cases = n_blockparallel = 0
    for src, dst in tc.PAIRS:
        cap_factor = tc.CAP_FACTOR[(src, dst)]
        for name, arr, n_valid in one_inputs[src]:
            x = torch.from_numpy(arr).cuda()
            n = len(arr) if n_valid is None else n_valid
            cap = cap_factor * len(arr)
            for errors in ("strict", "replace"):
                for validate in (True, False):
                    ctx = (src, dst, name, errors, validate)
                    one = repro_torch.transcode(
                        x, dst, src_format=src, n_valid=n_valid,
                        errors=errors, validate=validate)
                    fused = repro_torch.transcode(
                        x, dst, src_format=src, n_valid=n_valid,
                        errors=errors, validate=validate, strategy="fused")
                    for a, b in zip(one, fused):
                        require(equal(a, b), "onepass vs fused", *ctx)
                    hold_blockparallel(repro_torch.transcode(
                        x, dst, src_format=src, n_valid=n_valid,
                        errors=errors, validate=validate,
                        strategy="blockparallel"), fused, *ctx)
                    n_blockparallel += 1
                    k_o = hold_kernels(x, n, cap, src, dst, errors, validate,
                                       *ctx)
                    require(equal(one.buffer, k_o[0]), "entry", *ctx)
                    # CPython's codecs, where they decode the input.
                    # (The status of Latin-1 egress also reports
                    # unencodable code points, which CPython's decode
                    # does not see.)
                    units, first = oracle(arr, n, src, dst, errors)
                    if units is not None:
                        got = one.buffer[:int(one.count)].cpu().numpy()
                        require(np.array_equal(got, units), "codecs", *ctx)
                    if validate and dst != "latin1":
                        want = -1 if first is None else first
                        require(int(one.status) == want, "codecs status",
                                int(one.status), want, *ctx)
                    n_cases += 1
            cnt, st = repro_torch.scan(x, dst, src_format=src,
                                       n_valid=n_valid)
            ref = repro_torch.transcode(x, dst, src_format=src,
                                        n_valid=n_valid, strategy="fused")
            require(int(cnt) == int(ref.count) and int(st) == int(ref.status),
                    "scan", src, dst, name)
            cnt, st = repro_torch.scan(x, dst, src_format=src,
                                       n_valid=n_valid,
                                       strategy="blockparallel")
            require(cnt.dtype == st.dtype == torch.int32
                    and int(cnt) == int(ref.count)
                    and int(st) == int(ref.status),
                    "blockparallel scan", src, dst, name)
    torch.cuda.synchronize()
    report["correctness_cases"] = n_cases
    report["blockparallel_cases"] = n_blockparallel
    log(f"phase 2: {n_cases} single-buffer cases bit-identical (kernels = "
        f"plain, onepass = fused, codecs agree); {n_blockparallel} "
        f"blockparallel transcodes and their scans = fused (int32 buffer, "
        f"zeros past count)")

    r_inputs = {fmt: ragged_inputs(fmt, text_cps, rng) for fmt in PY_CODEC}
    n_ragged = 0
    for src, dst in tc.PAIRS:
        for name, docs, data, offsets, lengths in r_inputs[src]:
            x = torch.from_numpy(data).cuda()
            for errors in ("strict", "replace"):
                for validate in (True, False):
                    ctx = (src, dst, f"ragged {name}", errors, validate)
                    kw = dict(src_format=src, dst_format=dst, errors=errors,
                              validate=validate)
                    one = repro_torch.ragged_transcode(x, offsets, lengths,
                                                       **kw)
                    fused = repro_torch.ragged_transcode(
                        x, offsets, lengths, strategy="fused", **kw)
                    for a, b in zip(one, fused):
                        require(equal(a, b), "ragged onepass vs fused", *ctx)
                    k_o = hold_ragged(x, offsets, lengths, src, dst, errors,
                                      validate, *ctx)
                    require(equal(one.buffer, k_o[0]), "ragged entry", *ctx)
                    same_as_single(one, docs, src, dst, errors, validate,
                                   range(len(docs)), *ctx)
                    if errors == "strict" and validate:
                        counts, statuses = repro_torch.ragged_scan(
                            x, offsets, lengths, src_format=src,
                            dst_format=dst)
                        require(equal(counts, one.counts)
                                and equal(statuses, one.statuses),
                                "ragged_scan", *ctx)
                    n_ragged += 1
    torch.cuda.synchronize()
    report["ragged_correctness_cases"] = n_ragged
    log(f"phase 2: {n_ragged} ragged cases bit-identical (kernels = plain, "
        f"onepass = fused, every document = its single-buffer transcode)")

    # The count, write and one-pass kernels on tiles of each class, with a
    # class-breaking unit only in a tile's inflow, and on views 1-15 bytes
    # past a 16-byte boundary (the vector loads' fallback): count and
    # onepass under every policy at the aligned start, strict with
    # validation at every other, write under both errors= policies at the
    # aligned start and strict at every other; rcount and ronepass under
    # every policy at every view; the plain versions and the general body
    # run on the host.
    n_class, n_class_write, n_class_onepass = 0, 0, 0
    class_tiles = {"ascii": 0, "class2": 0, "general": 0, "tiles": 0}
    for src, dst in tc.PAIRS:
        size = np.dtype(NP_DTYPE[src]).itemsize
        cap_factor = tc.CAP_FACTOR[(src, dst)]
        for name, arr in class_inputs(src, class_rng):
            host = torch.from_numpy(arr)
            for key, v in class_counts(stages, src, host).items():
                class_tiles[key] += v
            # The write pass's plain version and general body, per policy,
            # on the host.
            want = {}
            for errors in ("strict", "replace"):
                kw = dict(src=src, dst=dst, errors=errors)
                base, _total = compaction.tile_base_offsets(
                    ft.count_plain(host, len(arr), validate=False, **kw)[0])
                cap = cap_factor * len(arr)
                plain = ft.write_plain(host, len(arr), base, cap, **kw)
                hold("write", plain, general_write(
                    host, base, cap, src, dst, errors, n=len(arr)), max_err,
                     "class plain vs general body", name, errors)
                want[errors] = (base.cuda(), cap, plain)
            raw = torch.zeros(len(arr) + 16 // size,
                              dtype=getattr(torch, NP_DTYPE[src].__name__),
                              device="cuda")
            for shift in range(0, 16, size):
                x = raw[shift // size: shift // size + len(arr)]
                x.copy_(host.cuda())
                require(x.data_ptr() % 16 == shift, "view alignment", shift)
                for errors, validate in ((("strict", True), ("strict", False),
                                          ("replace", True),
                                          ("replace", False)) if shift == 0
                                         else (("strict", True),)):
                    kw = dict(src=src, dst=dst, errors=errors,
                              validate=validate)
                    hold("count", tuple(t.cpu() for t in ft.count_kernel(
                        x, len(arr), **kw)), ft.count_plain(
                            host, len(arr), **kw),
                         max_err, "class", name, shift, *kw.values())
                    n_class += 1
                    if validate:
                        base, cap, plain = want[errors]
                        hold("write", ft.write_kernel(
                            x, len(arr), base, cap, src=src, dst=dst,
                            errors=errors).cpu(), plain, max_err, "class",
                             name, shift, errors)
                        n_class_write += 1
                    # The one-pass kernel against its plain version, whose
                    # buffer is the write pass's.
                    _b, cap, plain = want[errors]
                    o_plain = op.onepass_plain(host, len(arr), cap, **kw)
                    require(equal(o_plain[0], plain), "class onepass plain "
                            "vs write plain", name, *kw.values())
                    hold("onepass", tuple(t.cpu() for t in op.onepass_kernel(
                        x, len(arr), cap, **kw)), o_plain, max_err, "class",
                         name, shift, *kw.values())
                    n_class_onepass += 1
        bufs = dict(class_inputs(src, class_rng))
        docs = [bufs["ascii"][:1500], bufs["class2"][:2048],
                bufs["mixed"][:700], np.concatenate([
                    [CLASS_BREAK[src]], bufs["ascii"][:1200]]).astype(
                        NP_DTYPE[src]), bufs["ascii"][:0],
                bufs["class2"][:3000]]
        pk = packing.pack_documents(docs, dtype=NP_DTYPE[src])
        own, span = ownership(pk.data, pk.offsets, pk.lengths)
        own_cpu = tuple(t.cpu() for t in own)
        raw = torch.zeros(len(pk.data) + 16 // size,
                          dtype=getattr(torch, NP_DTYPE[src].__name__),
                          device="cuda")
        host = torch.from_numpy(pk.data)
        rwant = {}
        for errors in ("strict", "replace"):
            kw = dict(src=src, dst=dst, errors=errors)
            base, _total = compaction.tile_base_offsets(
                rt.rcount_plain(host, own_cpu, validate=False, **kw)[0])
            cap = cap_factor * span
            plain = rt.rwrite_plain(host, own_cpu, base, cap, **kw)
            hold("rwrite", plain, general_write(
                host, base, cap, src, dst, errors, own=own_cpu), max_err,
                 "class docs plain vs general body", errors)
            rwant[errors] = (base.cuda(), cap, plain)
        for shift in (0, size, 16 - size):
            x = raw[shift // size: shift // size + len(pk.data)]
            x.copy_(host.cuda())
            for errors in ("strict", "replace"):
                for validate in (True, False):
                    kw = dict(src=src, dst=dst, errors=errors,
                              validate=validate)
                    hold("rcount", tuple(t.cpu() for t in rt.rcount_kernel(
                        x, own, **kw)), rt.rcount_plain(
                            host, own_cpu, **kw),
                         max_err, "class docs", shift, *kw.values())
                    n_class += 1
                    r_plain = rt.ronepass_plain(host, own_cpu,
                                                rwant[errors][1], **kw)
                    require(equal(r_plain[0], rwant[errors][2]),
                            "class docs ronepass plain vs rwrite plain",
                            *kw.values())
                    hold("ronepass", tuple(t.cpu() for t in rt.ronepass_kernel(
                        x, own, rwant[errors][1], **kw)), r_plain, max_err,
                         "class docs", shift, *kw.values())
                    n_class_onepass += 1
                base, cap, plain = rwant[errors]
                hold("rwrite", rt.rwrite_kernel(
                    x, own, base, cap, src=src, dst=dst,
                    errors=errors).cpu(), plain, max_err, "class docs",
                     shift, errors)
                n_class_write += 1
    torch.cuda.synchronize()
    report["class_cases"] = n_class
    report["class_write_cases"] = n_class_write
    report["class_onepass_cases"] = n_class_onepass
    report["class_input_tiles"] = class_tiles
    log(f"phase 2: {n_class} tile-class cases of count and rcount, "
        f"{n_class_write} of write and rwrite and {n_class_onepass} of "
        f"onepass and ronepass bit-identical to plain, whose write units "
        f"equal the general body's and whose one-pass buffers equal the "
        f"write pass's (ASCII, <=2-byte and general tiles, class breakers in "
        f"the inflow only, views 1-15 bytes past a 16-byte boundary); class "
        f"inputs' tiles by class {class_tiles}")

    # The legacy kernel surface (kernels/ops.py), against CPython.
    n_legacy = 0
    for fmt, name, arr, n_valid in legacy_inputs(text_cps, legacy_rng):
        x = torch.from_numpy(arr).cuda()
        n = len(arr) if n_valid is None else n_valid
        ctx = ("legacy", fmt, name)
        hold_legacy(x, n, fmt, *ctx)
        try:
            text, valid = arr[:n].tobytes().decode(PY_CODEC[fmt]), True
        except UnicodeDecodeError:
            text, valid = None, False
        if fmt == "utf8":
            require(bool(ops.validate_utf8(x, n_valid)) == valid,
                    "validate_utf8 vs codecs", *ctx)
            cp, lead, units, derr = ops.decode_utf8(x, n_valid)
            require(cp.shape == lead.shape == units.shape == (len(arr),)
                    and not (valid and bool(derr)), "decode_utf8", *ctx)
            out, count, err = ops.utf8_to_utf16(x, n_valid)
            want = None if not valid else np.frombuffer(
                text.encode("utf-16-le"), np.uint16)
        else:
            out, count, err = ops.utf16_to_utf8(x, n_valid)
            want = None if not valid else np.frombuffer(
                text.encode("utf-8"), np.uint8)
        require(out.dtype == torch.int32 and bool(err) == (not valid),
                "legacy err vs codecs", *ctx, bool(err), valid)
        if want is not None:
            require(int(count) == len(want) and np.array_equal(
                out[:int(count)].cpu().numpy(), want), "legacy vs codecs",
                *ctx)
        n_legacy += 1
    torch.cuda.synchronize()
    report["legacy_correctness_cases"] = n_legacy
    log(f"phase 2: {n_legacy} legacy-ops cases (validate, decode, encode "
        f"kernels = plain on narrow and int32 input; ops = codecs)")

    # The validation kernel on tiles of each class of its dispatch
    # (tools/inputs.py's buffers: class breakers in the inflow
    # only, n cut mid-tile and mid-character, int32 outside [0, 256)),
    # narrow and int32, at the aligned start and 1-15 bytes past a
    # 16-byte boundary; then one tile per byte pair, all 65,536.  Held to
    # validate_plain (no dispatch), which validate_classes (the dispatch
    # in torch) must equal too.
    n_val = 0
    for name, arr, n in inputs.validate_buffers(args.seed):
        host = torch.from_numpy(arr)
        want = kval.validate_plain(host, n)
        require(equal(kval.validate_classes(host, n), want),
                "validate_classes vs plain", name)
        narrow = arr.dtype == np.uint8
        raw = torch.zeros(len(arr) + 16, dtype=host.dtype, device="cuda")
        for shift in (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
                      15, "int32") if narrow else (0,):
            if shift == "int32":
                xx = host.to(torch.int32).cuda()
            else:
                xx = raw[shift: shift + len(arr)]
                xx.copy_(host.cuda())
            hold("validate", kval.validate_kernel(xx, n).cpu(), want,
                 max_err, "validate classes", name, shift)
            n_val += 1
    pairs = torch.from_numpy(inputs.byte_pairs()).cuda()
    for xx in (pairs, pairs.to(torch.int32)):
        want = kval.validate_plain(xx, xx.shape[0])
        require(equal(kval.validate_classes(xx, xx.shape[0]), want),
                "validate_classes vs plain on byte pairs", xx.dtype)
        hold("validate", kval.validate_kernel(xx, xx.shape[0]), want,
             max_err, "validate byte pairs", xx.dtype)
        n_val += 1
    del pairs
    torch.cuda.synchronize()
    report["validate_class_cases"] = n_val
    log(f"phase 2: {n_val} validate-kernel cases bit-identical to plain and "
        f"to validate_classes (tiles of each class, inflow-only breakers, "
        f"cut n, int32 outside [0, 256), views 1-15 bytes past a 16-byte "
        f"boundary, all 65,536 byte pairs)")

    # Flash attention at small shapes, kernel vs plain, and causality.
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    n_flash = 0
    for b, sq, sk, h, d, windows, bq, bk in FLASH_SMALL:
        for window in windows:
            for dt in ("float32", "bfloat16"):
                q, k, v = (torch.randn(b, s_, h, d, generator=gen,
                                       device="cuda").to(getattr(torch, dt))
                           for s_ in (sq, sk, sk))
                ctx = ("flash", b, sq, sk, h, d, window, bq, bk, dt)
                got = fa.flash_kernel(q, k, v, window, bq, bk)
                hold_close("flash", got,
                           fa.flash_plain(q, k, v, window, bq, bk), dt,
                           max_err, *ctx)
                if sq == sk:
                    cut = sq // 2 + 3
                    k2, v2 = k.clone(), v.clone()
                    k2[:, cut:], v2[:, cut:] = 9.9, 9.9
                    again = fa.flash_kernel(q, k2, v2, window, bq, bk)
                    require(equal(got[:, :cut], again[:, :cut]),
                            "flash causality", *ctx)
                n_flash += 1
    torch.cuda.synchronize()
    report["flash_correctness_cases"] = n_flash
    log(f"phase 2: {n_flash} flash cases within tolerance of plain "
        f"(f32 atol 2e-5 rtol 1e-4, bf16 atol 1e-4 rtol 1e-2; TF32 off), "
        f"causal")

    # The windowed walks (one warp each) on tools/inputs.py's windowed
    # buffers: text of every profile, injected errors, lone high
    # surrogates whose count passes the capacity, int32 values outside the
    # byte and unit ranges, n_valid at 0, below a window and
    # mid-character; validate on and off.  Kernel vs plain, then windowed
    # transcode = fused on valid text of every profile.
    n_win = 0
    for fmt, (kern, plain, first_error) in walks.items():
        for label, arr, n in inputs.windowed_buffers(
                fmt, args.seed + 5, ring=(win.STAGE_BYTES, win.RING_STAGES)):
            x = torch.from_numpy(arr).cuda()[inputs.view_offset(label):]
            status0 = first_error(win.masked_int32(x, n), n)
            for validate in (True, False):
                hold(f"windowed_{fmt}", kern(x, n, status0, validate),
                     plain(x, n, status0, validate), max_err, fmt, label,
                     validate)
                n_win += 1
    windowed_rng = np.random.default_rng([args.seed, 4])
    for lang in inputs.PROFILES:
        cps = inputs.codepoints(lang, 5000, windowed_rng)
        for src, dst in WINDOWED:
            x = torch.from_numpy(encode(cps, src)).cuda()
            hold_windowed(
                repro_torch.transcode(x, dst, src_format=src,
                                      strategy="windowed"),
                repro_torch.transcode(x, dst, src_format=src,
                                      strategy="fused"), lang, src)
            n_win += 1
    torch.cuda.synchronize()
    report["windowed_correctness_cases"] = n_win
    log(f"phase 2: {n_win} windowed cases: both walks' kernels bit-identical "
        f"to plain (text, injected errors, lone high surrogates past the "
        f"capacity, int32 out of range, n_valid edges; the ring's: three "
        f"ring lengths, features across stage boundaries, n mid-stage, a "
        f"misaligned view, validate on/off); windowed transcode = fused "
        f"on text of every profile")

    # The fault harness on the card: an error at the one-pass wrapper's
    # second call (the next call clean and equal to the first), and a
    # truncated stream chunk (the stream equals a clean stream of what
    # the truncation left).
    x = torch.from_numpy(encode(text_cps[:4000], "utf8")).cuda()
    with faults.harness(faults.Fault(faults.KERNEL_ONEPASS,
                                     times=(2,))) as fh:
        first = repro_torch.transcode(x, "utf16")
        raised = False
        try:
            repro_torch.transcode(x, "utf16")
        except faults.FaultInjected:
            raised = True
        third = repro_torch.transcode(x, "utf16")
    require(raised and fh.fired == [(faults.KERNEL_ONEPASS, "error", 2)]
            and fh.calls == {faults.KERNEL_ONEPASS: 3},
            "onepass fault", fh.fired, fh.calls)
    for a, b in zip(first, third):
        require(equal(a, b), "transcode after an injected fault")
    data = encode(text_cps[:3000], "utf8")
    step, cut = 701, 5
    with faults.harness(faults.Fault(faults.STREAM_CHUNK, kind="truncate",
                                     truncate_to=cut, times=(2,))) as fh:
        tres, _st = repro_torch.transcode_stream(
            [data[i: i + step] for i in range(0, len(data), step)],
            src_format="utf8", dst_format="utf16")
    kept = np.concatenate([data[:step + cut], data[2 * step:]])
    cres, _st = repro_torch.transcode_stream(
        [kept[i: i + step] for i in range(0, len(kept), step)],
        src_format="utf8", dst_format="utf16")
    require(fh.fired == [(faults.STREAM_CHUNK, "truncate", 2)]
            and int(tres.count) == int(cres.count)
            and int(tres.status) == int(cres.status)
            and np.array_equal(tres.buffer, cres.buffer),
            "truncated stream vs the stream of what was kept", fh.fired)
    log(f"phase 2: fault harness on the card: onepass error at call 2 "
        f"raised, call 3 = call 1; stream chunk 2 truncated to {cut} units "
        f"= a clean stream of the kept units (status {int(tres.status)})")

    # -- 3. the main path, with launch counts --------------------------------
    main_bytes = MAIN_BYTES
    main_cps = inputs.codepoints("arabic", main_bytes * 10 // 17, rng)
    u8 = inputs.utf8_encode(main_cps)
    ends = np.cumsum(1 + (main_cps >= 0x80) + (main_cps >= 0x800)
                     + (main_cps >= 0x10000))
    k = int(np.searchsorted(ends, main_bytes, side="right"))
    require(k < len(main_cps), "main-path text too short")
    x8 = np.full(main_bytes, 0x20, np.uint8)
    x8[:ends[k - 1]] = u8[:ends[k - 1]]
    want16 = np.concatenate([utf16_encode(main_cps[:k]),
                             np.full(main_bytes - ends[k - 1], 0x20,
                                     np.uint16)])
    x_main = torch.from_numpy(x8).cuda()
    torch.cuda.synchronize()
    zero_counts()
    res = repro_torch.transcode(x_main, "utf16")
    res_fused = repro_torch.transcode(x_main, "utf16", strategy="fused")
    cnt, st = repro_torch.scan(x_main, "utf16")
    launches = read_counts()
    log(f"phase 3: main path launches {launches}")
    for name in ("count", "write", "onepass"):
        require(launches.get(name, 0) > 0,
                f"kernel {name} never launched on the main path")
    require(int(res.count) == len(want16) and int(res.status) == -1,
            "main path count/status", int(res.count), int(res.status))
    require(np.array_equal(res.buffer[:len(want16)].cpu().numpy(), want16),
            "main path buffer")
    for a, b in zip(res, res_fused):
        require(equal(a, b), "main path onepass vs fused")
    require(int(cnt) == len(want16) and int(st) == -1, "main path scan")
    report["main_path"] = {"bytes": main_bytes, "units_out": len(want16),
                           "launches": launches}

    # The blockparallel strategy on the same buffer: whole-array torch ops
    # on the card, no hand kernel (its counts must stay 0).
    zero_counts()
    bp_res = repro_torch.transcode(x_main, "utf16", strategy="blockparallel")
    bp_cnt, bp_st = repro_torch.scan(x_main, "utf16",
                                     strategy="blockparallel")
    bp_launches = read_counts()
    require(bp_launches == {}, "blockparallel launched a kernel",
            bp_launches)
    hold_blockparallel(bp_res, res, "64 MiB blockparallel")
    require(int(bp_cnt) == int(res.count) and int(bp_st) == int(res.status),
            "64 MiB blockparallel scan")
    del bp_res
    report["main_path"]["blockparallel_launches"] = bp_launches
    log("phase 3: 64 MiB blockparallel transcode = default transcode "
        "(int32 buffer), its scan = scan; no kernel launched")

    # Every kernel against its plain version at the main path's size.
    nblk_main = main_bytes // BLOCK
    spread = rng.choice(np.arange(1, nblk_main), size=nblk_main // 16,
                        replace=False)
    main_inputs = [("main", x8), ("injected", inject(x8, "utf8", spread)),
                   ("late error", inject(x8, "utf8", [nblk_main - 2]))]
    n_main = 0
    for name, arr in main_inputs:
        x = torch.from_numpy(arr).cuda()
        for errors in ("strict", "replace"):
            for validate in (True, False):
                ctx = ("utf8", "utf16", f"64 MiB {name}", errors, validate)
                k_o = hold_kernels(x, main_bytes, main_bytes, "utf8",
                                   "utf16", errors, validate, *ctx,
                                   repeats=True)
                fused = repro_torch.transcode(
                    x, "utf16", errors=errors, validate=validate,
                    strategy="fused")
                require(equal(k_o[0], fused.buffer)
                        and equal(k_o[1], torch.stack([fused.count,
                                                       fused.status])),
                        "onepass vs fused", *ctx)
                n_main += 1
        del x
    torch.cuda.synchronize()
    report["main_size_cases"] = n_main
    log(f"phase 3: {n_main} cases at 64 MiB bit-identical (kernels = "
        f"plain, onepass = fused; onepass launched {REPEATS} times each)")
    # The count, one-pass and write kernels on the 64 MiB buffer as a view
    # 3 bytes past a 16-byte boundary (no vector loads), and how much of
    # the buffer each of their tile classes covers.
    raw = torch.zeros(main_bytes + 16, dtype=torch.uint8, device="cuda")
    x_off = raw[3: 3 + main_bytes]
    x_off.copy_(x_main)
    kw = dict(src="utf8", dst="utf16", errors="strict", validate=True)
    k_cnt = ft.count_kernel(x_off, main_bytes, **kw)
    hold("count", k_cnt, ft.count_plain(x_off, main_bytes, **kw), max_err,
         "64 MiB view +3")
    hold("onepass", op.onepass_kernel(x_off, main_bytes, main_bytes, **kw),
         op.onepass_plain(x_off, main_bytes, main_bytes, **kw), max_err,
         "64 MiB view +3")
    base, _total = compaction.tile_base_offsets(k_cnt[0])
    kw = dict(src="utf8", dst="utf16", errors="strict")
    hold("write", ft.write_kernel(x_off, main_bytes, base, main_bytes, **kw),
         ft.write_plain(x_off, main_bytes, base, main_bytes, **kw), max_err,
         "64 MiB view +3")
    del raw, x_off, k_cnt
    for name, arr in main_inputs[:2]:
        x = torch.from_numpy(arr).cuda()
        for errors in ("strict", "replace"):
            kw = dict(src="utf8", dst="utf16", errors=errors, validate=True)
            k_cnt = ft.count_kernel(x, main_bytes, **kw)
            hold("count", k_cnt, general_count(x, n=main_bytes, **kw),
                 max_err, "64 MiB general body", name, errors)
            base, _total = compaction.tile_base_offsets(k_cnt[0])
            hold("write", ft.write_kernel(x, main_bytes, base, main_bytes,
                                          src="utf8", dst="utf16",
                                          errors=errors),
                 general_write(x, base, main_bytes, "utf8", "utf16", errors,
                               n=main_bytes), max_err,
                 "64 MiB general body", name, errors)
        del x
    main_classes = class_counts(stages, "utf8", torch.from_numpy(x8))
    report["main_path"]["tile_classes"] = main_classes
    log(f"phase 3: 64 MiB tiles by class {main_classes}; count, onepass and "
        f"write kernels on a view 3 bytes past a 16-byte boundary = plain; "
        f"count "
        f"and write kernels on the main and injected buffers = the general "
        f"body (no class dispatch)")

    # The ASCII class switched off (``ascii_fastpath=False``): on 64 MiB of
    # the latin profile (every tile ASCII) and of the arabic one, count,
    # write and onepass give the same outputs off as on and as their plain
    # versions off, bit for bit; their device times both ways give the
    # class's worth on the card.
    switch_rng = np.random.default_rng([args.seed, 30])
    ascii_t = {}
    for lang in ("latin", "arabic"):
        host8 = x8 if lang == "arabic" else inputs.utf8_buffer(
            lang, main_bytes, switch_rng)
        x = torch.from_numpy(host8).cuda()
        kw = dict(src="utf8", dst="utf16", errors="strict")
        base, _total = compaction.tile_base_offsets(
            ft.count_kernel(x, main_bytes, validate=True, **kw)[0])
        switch = {
            "count": (lambda a: ft.count_kernel(
                x, main_bytes, validate=True, ascii_fastpath=a, **kw),
                lambda: ft.count_plain(x, main_bytes, validate=True,
                                       ascii_fastpath=False, **kw)),
            "write": (lambda a: ft.write_kernel(
                x, main_bytes, base, main_bytes, ascii_fastpath=a, **kw),
                lambda: ft.write_plain(x, main_bytes, base, main_bytes,
                                       ascii_fastpath=False, **kw)),
            "onepass": (lambda a: op.onepass_kernel(
                x, main_bytes, main_bytes, validate=True, ascii_fastpath=a,
                **kw),
                lambda: op.onepass_plain(x, main_bytes, main_bytes,
                                         validate=True, ascii_fastpath=False,
                                         **kw))}
        row = {"tiles": class_counts(stages, "utf8", torch.from_numpy(host8))}
        for name, (call, plain) in switch.items():
            on, off = call(True), call(False)
            if not isinstance(on, tuple):
                on, off = (on,), (off,)
            require(all(equal(a, b) for a, b in zip(on, off, strict=True)),
                    f"{name} ascii_fastpath off vs on", lang)
            hold(name, off if len(off) > 1 else off[0], plain(), max_err,
                 "ascii_fastpath off", lang)
            row[name] = {"device_ms_on": device_ms(lambda: call(True), 10),
                         "device_ms_off": device_ms(lambda: call(False), 10)}
        ascii_t[lang] = row
        log(f"phase 3: ascii_fastpath off on 64 MiB {lang} (tiles "
            f"{row['tiles']}): count, write, onepass = on = plain, bit for "
            "bit; device ms on / off: " + ", ".join(
                f"{n} {row[n]['device_ms_on']:.4f} / "
                f"{row[n]['device_ms_off']:.4f}" for n in switch)
            + f"  [{smi}]")
        del x
    report["ascii_fastpath"] = ascii_t

    # The main ragged batch: ragged_transcode (onepass, fused) and
    # ragged_scan, each with the counts set to 0 just before it.
    docs, cps_of, injected = main_ragged_docs(rng)
    pk = packing.pack_documents(docs)
    x_rag = torch.from_numpy(pk.data).cuda()
    rag_args = (x_rag, pk.offsets, pk.lengths)
    torch.cuda.synchronize()
    rag_calls = {
        "ragged_transcode": lambda: repro_torch.ragged_transcode(*rag_args),
        "ragged_transcode fused": lambda: repro_torch.ragged_transcode(
            *rag_args, strategy="fused"),
        "ragged_scan": lambda: repro_torch.ragged_scan(*rag_args)}
    rag_out, per_call = {}, {}
    for label, fn in rag_calls.items():
        zero_counts()
        rag_out[label] = fn()
        per_call[label] = read_counts()
    log(f"phase 3: ragged path launches per call {per_call}")
    require(per_call == {"ragged_transcode": {"ronepass": 1},
                         "ragged_transcode fused": {"rcount": 1, "rwrite": 1},
                         "ragged_scan": {"rcount": 1}},
            "ragged path launches", per_call)
    for label, counts in per_call.items():
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
    rres = rag_out["ragged_transcode"]
    for a, b in zip(rres, rag_out["ragged_transcode fused"]):
        require(equal(a, b), "main ragged onepass vs fused")
    require(equal(rag_out["ragged_scan"][0], rres.counts)
            and equal(rag_out["ragged_scan"][1], rres.statuses),
            "main ragged scan")
    counts = rres.counts.cpu().numpy()
    statuses = rres.statuses.cpu().numpy()
    out_offsets = rres.offsets.cpu().numpy()
    out_host = rres.buffer.cpu().numpy()
    require(np.array_equal(out_offsets[1:], np.cumsum(counts)),
            "main ragged offsets")
    for d, cps in enumerate(cps_of):
        if d in injected:
            require(0 <= statuses[d] <= injected[d], "main ragged status", d)
            continue
        want = utf16_encode(cps)
        lo = int(out_offsets[d])
        require(int(counts[d]) == len(want) and statuses[d] == -1
                and np.array_equal(out_host[lo: lo + len(want)], want),
                "main ragged document vs encoder", d)
    sample = sorted(set(rng.choice(RAGGED_DOCS, 48, replace=False).tolist())
                    | set(list(injected)[:8]) | {0, 63, RAGGED_DOCS - 1})
    same_as_single(rres, docs, "utf8", "utf16", "strict", True, sample,
                   "main ragged")
    n_rag_main = 0
    spread_docs = rng.choice(RAGGED_DOCS, RAGGED_DOCS // 16, replace=False)
    bad_data = pk.data.copy()
    for k, d in enumerate(spread_docs):      # at and across document ends
        lo, n = int(pk.offsets[d]), int(pk.lengths[d])
        if n:
            bad_data[lo + (n - 1 if k % 2 else 0)] = BAD_UNITS["utf8"][
                k % len(BAD_UNITS["utf8"])]
    for name, arr in (("main", None), ("injected", bad_data)):
        x = x_rag if arr is None else torch.from_numpy(arr).cuda()
        for errors in ("strict", "replace"):
            for validate in (True, False):
                ctx = ("utf8", "utf16", f"ragged {name}", errors, validate)
                k_o = hold_ragged(x, pk.offsets, pk.lengths, "utf8", "utf16",
                                  errors, validate, *ctx, repeats=True)
                fused = repro_torch.ragged_transcode(
                    x, pk.offsets, pk.lengths, errors=errors,
                    validate=validate, strategy="fused")
                require(equal(k_o[0], fused.buffer), "ragged onepass vs "
                        "fused", *ctx)
                n_rag_main += 1
        del x
    torch.cuda.synchronize()
    report["ragged_main"] = {
        "docs": RAGGED_DOCS, "bytes": int(pk.lengths.sum()),
        "packed_bytes": len(pk.data), "tiles": len(pk.data) // BLOCK,
        "units_out": int(counts.sum()), "injected_docs": len(injected),
        "launches_per_call": per_call, "size_cases": n_rag_main}
    rag_own = packing.tile_ownership(
        torch.from_numpy(pk.offsets), torch.from_numpy(pk.lengths),
        max(1, -(-len(pk.data) // BLOCK)))
    rag_classes = class_counts(stages, "utf8", torch.from_numpy(pk.data),
                               rag_own)
    report["ragged_main"]["tile_classes"] = rag_classes
    own_rag, span_rag = ownership(x_rag, pk.offsets, pk.lengths)
    for name, arr in (("main", None), ("injected", bad_data)):
        x = x_rag if arr is None else torch.from_numpy(arr).cuda()
        for errors in ("strict", "replace"):
            kw = dict(src="utf8", dst="utf16", errors=errors, validate=True)
            k_cnt = rt.rcount_kernel(x, own_rag, **kw)
            hold("rcount", k_cnt, general_count(x, own=own_rag, **kw),
                 max_err, "ragged general body", name, errors)
            base, _total = compaction.tile_base_offsets(k_cnt[0])
            hold("rwrite", rt.rwrite_kernel(x, own_rag, base, span_rag,
                                            src="utf8", dst="utf16",
                                            errors=errors),
                 general_write(x, base, span_rag, "utf8", "utf16", errors,
                               own=own_rag), max_err, "ragged general body",
                 name, errors)
        del x
    log(f"phase 3: ragged batch tiles by class {rag_classes}; rcount and "
        f"rwrite kernels on the main and injected batches = the general "
        f"body")
    log(f"phase 3: ragged batch of {RAGGED_DOCS} documents "
        f"({int(pk.lengths.sum())} bytes, {len(pk.data) // BLOCK} tiles): "
        f"every valid document = encoder, {len(sample)} sampled = single "
        f"buffer, {n_rag_main} cases bit-identical (kernels = plain, "
        f"onepass = fused; ronepass launched {REPEATS} times each)")

    # The stream: the 64 MiB buffer in chunks of seeded random sizes.
    sizes = np.exp(rng.uniform(0, np.log(STREAM_MAX_CHUNK), 4 * (
        main_bytes // STREAM_MAX_CHUNK + 64))).astype(np.int64)
    cuts = np.cumsum(sizes)
    cuts = cuts[cuts < main_bytes]
    require(len(cuts) < len(sizes), "stream chunks do not cover the buffer")
    mid_char = int(((x8[cuts] & 0xC0) == 0x80).sum())
    require(mid_char > 0, "no stream split falls mid-character")
    chunks = np.split(x8, cuts)
    zero_counts()
    t0 = time.time()
    sres, sstate = repro_torch.transcode_stream(chunks, src_format="utf8",
                                                dst_format="utf16")
    stream_s = time.time() - t0
    stream_launches = read_counts()
    log(f"phase 3: stream path launches {stream_launches}")
    require(stream_launches.get("onepass", 0) > 0,
            "kernel onepass never launched on the stream path")
    require(int(sres.count) == int(res.count) and int(sres.status) == -1
            and sstate.consumed == main_bytes
            and np.array_equal(sres.buffer,
                               res.buffer[:int(res.count)].cpu().numpy()),
            "stream vs whole-buffer transcode")
    report["stream"] = {"bytes": main_bytes, "chunks": len(chunks),
                        "mid_character_splits": mid_char,
                        "launches": stream_launches, "host_s": stream_s,
                        "GB_per_s_in": main_bytes / stream_s / 1e9}
    log(f"phase 3: stream of {main_bytes} bytes in {len(chunks)} chunks "
        f"({mid_char} split mid-character) = whole-buffer transcode; "
        f"{stream_s * 1e3:.1f} ms host clock "
        f"({main_bytes / stream_s / 1e9:.2f} GB/s)  [{smi}]")
    # The legacy kernel surface on the 64 MiB buffer, then back from its
    # UTF-16 transcode; counts set to 0 before and read after each path.
    u16_main = res.buffer[:int(res.count)]
    zero_counts()
    ok_main = ops.validate_utf8(x_main)
    dec_main = ops.decode_utf8(x_main)
    o16, c16, e16 = ops.utf8_to_utf16(x_main)
    legacy_launches = read_counts()
    zero_counts()
    o8, c8, e8 = ops.utf16_to_utf8(u16_main)
    enc_launches = read_counts()
    log(f"phase 3: legacy ops launches {legacy_launches}, utf16_to_utf8 "
        f"{enc_launches}")
    require(legacy_launches == {"validate": 2, "decode": 2}
            and enc_launches == {"encode": 1}, "legacy path launches",
            legacy_launches, enc_launches)
    for counts_ in (legacy_launches, enc_launches):
        launches.update(counts_)
    require(bool(ok_main) and not bool(dec_main[3]), "legacy main valid")
    require(int(c16) == int(res.count) and bool(e16) == (int(res.status)
                                                        != -1)
            and equal(o16[:int(c16)], u16_main.to(torch.int32)),
            "utf8_to_utf16 vs transcode")
    require(int(c8) == main_bytes and not bool(e8)
            and equal(o8[:int(c8)], x_main.to(torch.int32)),
            "utf16_to_utf8 back to the bytes")
    del o16, o8, dec_main
    u16_host = u16_main.cpu().numpy()
    nblk16 = -(-len(u16_host) // BLOCK)
    spread16 = legacy_rng.choice(np.arange(1, nblk16 - 1),
                                 size=nblk16 // 16, replace=False)
    n_legacy_main = 0
    for (name, arr), arr16 in zip(main_inputs, (u16_host, inject(
            u16_host, "utf16", spread16), None)):
        hold_legacy(torch.from_numpy(arr).cuda(), main_bytes, "utf8",
                    "64 MiB", name)
        n_legacy_main += 1
        if arr16 is not None:
            hold_legacy(torch.from_numpy(arr16).cuda(), len(arr16), "utf16",
                        "64 MiB", name)
            n_legacy_main += 1
    torch.cuda.synchronize()
    report["legacy_main"] = {"bytes": main_bytes, "utf16_units": len(u16_host),
                             "launches": {**legacy_launches, **enc_launches},
                             "size_cases": n_legacy_main}
    log(f"phase 3: legacy ops at 64 MiB = transcode and back; "
        f"{n_legacy_main} cases bit-identical (kernels = plain)")

    # Flash attention at the attention width of qwen3-8b and
    # h2o-danube-1.8b, k/v expanded from 8 KV heads (q head h reads KV
    # head h // 4, chunked_attention's grouping).
    flash_in = {}
    for label, s_len, d, window, dt in FLASH_MAIN:
        q = torch.randn(1, s_len, FLASH_HEADS, d, generator=gen,
                        device="cuda").to(getattr(torch, dt))
        k, v = (torch.randn(1, s_len, FLASH_KV_HEADS, d, generator=gen,
                            device="cuda").to(getattr(torch, dt))
                .repeat_interleave(FLASH_HEADS // FLASH_KV_HEADS, dim=2)
                for _ in range(2))
        flash_in[label] = (q, k, v, window, dt)
    torch.cuda.synchronize()
    zero_counts()
    flash_out = {label: fa.flash_attention(q, k, v, window=window)
                 for label, (q, k, v, window, _dt) in flash_in.items()}
    flash_launches = read_counts()
    log(f"phase 3: flash path launches {flash_launches}")
    require(flash_launches == {"flash": len(FLASH_MAIN)},
            "flash path launches", flash_launches)
    launches.update(flash_launches)
    for label, (q, k, v, window, dt) in flash_in.items():
        hold_close("flash", flash_out[label],
                   fa.flash_plain(q, k, v, window), dt, max_err, label)
    del flash_out
    torch.cuda.synchronize()
    log(f"phase 3: flash at {', '.join(flash_in)} within tolerance of plain "
        f"(max abs err {max_err['flash']:.3g})")

    # The windowed strategy at the size of the paper's Table 5/6 inputs:
    # 1<<17 characters of each lipsum profile, both directions, through
    # transcode(strategy="windowed"); each equal to fused.
    win_in = {}
    for lang in inputs.PROFILES:
        cps = inputs.codepoints(lang, LIPSUM_CHARS, windowed_rng)
        for src, dst in WINDOWED:
            win_in[(lang, src)] = torch.from_numpy(encode(cps, src)).cuda()
    torch.cuda.synchronize()
    zero_counts()
    win_out = {(lang, src): repro_torch.transcode(
        x, dict(WINDOWED)[src], src_format=src, strategy="windowed")
        for (lang, src), x in win_in.items()}
    win_launches = read_counts()
    log(f"phase 3: windowed path launches {win_launches}")
    # Each call seeds its status with one count launch (wire-type input).
    require(win_launches == {"windowed_utf8": len(inputs.PROFILES),
                             "windowed_utf16": len(inputs.PROFILES),
                             "count": 2 * len(inputs.PROFILES)},
            "windowed path launches", win_launches)
    for name, count in win_launches.items():
        launches[name] = launches.get(name, 0) + count
    for (lang, src), w in win_out.items():
        hold_windowed(w, repro_torch.transcode(
            win_in[(lang, src)], dict(WINDOWED)[src], src_format=src,
            strategy="fused"), lang, src, LIPSUM_CHARS)
    del win_out
    log(f"phase 3: windowed transcode of {LIPSUM_CHARS} characters of "
        f"{len(inputs.PROFILES)} profiles, utf8->utf16 and utf16->utf8, "
        f"= fused")

    # The data pipeline of a byte LM: PIPE_STEPS steps of TextPipeline on
    # the card, each batch equal to the same step on the CPU; the code
    # points of every document equal CPython's decode of its bytes.
    pipe_card = dp.TextPipeline(dp.PipelineConfig(seed=args.seed, **PIPE))
    pipe_host = dp.TextPipeline(dp.PipelineConfig(seed=args.seed, **PIPE),
                                device="cpu")
    torch.cuda.synchronize()
    zero_counts()
    batches = [pipe_card.next_batch() for _ in range(PIPE_STEPS)]
    pipe_launches = read_counts()
    log(f"phase 3: pipeline path launches {pipe_launches}")
    require(pipe_launches == {"ronepass": PIPE_STEPS}, "pipeline launches",
            pipe_launches)
    for step, batch in enumerate(batches):
        want = pipe_host.next_batch()
        require(set(batch) == set(want), "pipeline keys", step)
        for key, t in batch.items():
            require(t.device == pipe_card.device
                    and equal(t.cpu(), want[key]),
                    "pipeline card vs cpu", step, key)
        toks = batch["tokens"].cpu().numpy()
        cps_dev = batch["codepoints"].cpu().numpy()
        counts = batch["cp_counts"].cpu().numpy()
        for d in range(toks.shape[0]):
            n = int(np.argmax(toks[d] == 2)) - 1          # [BOS] doc [EOS]
            text = (toks[d, 1:n + 1] - 3).astype(np.uint8).tobytes()
            decoded = np.array([ord(c) for c in text.decode("utf-8")],
                               np.uint32)
            require(int(counts[d]) == len(decoded) and np.array_equal(
                cps_dev[d, :len(decoded)], decoded)
                and not cps_dev[d, len(decoded):].any(),
                "pipeline code points vs CPython", step, d)
    del batches
    log(f"phase 3: TextPipeline seq_len {PIPE['seq_len']} x "
        f"{PIPE['global_batch']} documents, {PIPE_STEPS} steps: card = "
        f"cpu, code points = CPython's decode")

    # batch_transcode on a [4096, 4096] UTF-8 batch (16 MiB) to UTF-16:
    # one packed ronepass launch equal to the per-document onepass
    # launches of strategy="vmap", as the reference's tests assert.
    batch_rng = np.random.default_rng([args.seed, 5])
    langs = list(inputs.PROFILES)
    bt_docs = np.stack([inputs.utf8_buffer(langs[i % len(langs)],
                                           BATCH_LEN, batch_rng)
                        for i in range(BATCH_DOCS)])
    bt_lens = batch_rng.integers(0, BATCH_LEN + 1, BATCH_DOCS).astype(
        np.int32)
    bt_lens[::4] = BATCH_LEN
    bt_x = torch.from_numpy(bt_docs).cuda()
    torch.cuda.synchronize()
    bt_launches, bt_out = {}, {}
    for strategy in ("packed", "vmap"):
        zero_counts()
        bt_out[strategy] = dp.batch_transcode(bt_x, bt_lens,
                                              strategy=strategy)
        bt_launches[strategy] = read_counts()
    log(f"phase 3: batch_transcode launches {bt_launches}")
    require(bt_launches == {"packed": {"ronepass": 1},
                            "vmap": {"onepass": BATCH_DOCS}},
            "batch_transcode launches", bt_launches)
    for a, b in zip(bt_out["packed"], bt_out["vmap"]):
        require(equal(a, b), "batch_transcode packed vs vmap")
    bt_bad = int((bt_out["packed"].status >= 0).sum())
    require(0 < bt_bad < BATCH_DOCS, "batch_transcode statuses", bt_bad)
    del bt_out
    log(f"phase 3: batch_transcode [{BATCH_DOCS}, {BATCH_LEN}] utf8->utf16 "
        f"packed = vmap ({bt_bad} documents cut mid-character report "
        f"their first error)")
    report["data_path"] = {"windowed_launches": win_launches,
                           "pipeline_launches": pipe_launches,
                           "batch_transcode_launches": bt_launches}
    report["max_abs_err"] = max_err

    # -- 4. timing -------------------------------------------------------------
    def time_kernels(x, src, dst, reps, plain_reps):
        """Each kernel's wrapper and its plain version on ``x`` (strict,
        validate), with the bytes bound of the function."""
        n = x.shape[0]
        cap = tc.CAP_FACTOR[(src, dst)] * n
        nblk = max(1, -(-n // BLOCK))
        in_bytes = n * x.element_size()
        out_bytes = cap * np.dtype(NP_DTYPE[dst]).itemsize
        kw = dict(src=src, dst=dst, errors="strict")
        base, _ = compaction.tile_base_offsets(
            ft.count_kernel(x, n, validate=True, **kw)[0])
        calls = {
            "count": (lambda: ft.count_kernel(x, n, validate=True, **kw),
                      lambda: ft.count_plain(x, n, validate=True, **kw),
                      in_bytes + 3 * 4 * nblk),
            "write": (lambda: ft.write_kernel(x, n, base, cap, **kw),
                      lambda: ft.write_plain(x, n, base, cap, **kw),
                      in_bytes + 4 * nblk + out_bytes),
            "onepass": (lambda: op.onepass_kernel(x, n, cap, validate=True,
                                                  **kw),
                        lambda: op.onepass_plain(x, n, cap, validate=True,
                                                 **kw),
                        in_bytes + out_bytes + 8),
        }
        out = {}
        for name, (kern_fn, plain_fn, nbytes) in calls.items():
            hold(name, kern_fn(), plain_fn(), max_err, "timed", src, dst,
                 n)
            ms = cuda_ms(kern_fn, reps=reps)
            out[name] = {"ms": ms, "device_ms": device_ms(kern_fn, reps),
                         "plain_ms": cuda_ms(plain_fn, reps=plain_reps,
                                             warmup=1),
                         "bound_ms": nbytes / roofline.HBM_BW * 1e3,
                         "bytes": nbytes, "GB_per_s": nbytes / ms / 1e6}
        return out

    def entry_ms(x, src, dst, reps):
        n = x.shape[0] * x.element_size()
        out = {}
        for label, fn in (
                ("transcode onepass", lambda: repro_torch.transcode(
                    x, dst, src_format=src)),
                ("transcode fused", lambda: repro_torch.transcode(
                    x, dst, src_format=src, strategy="fused")),
                ("scan", lambda: repro_torch.scan(x, dst, src_format=src)),
                ("transcode blockparallel", lambda: repro_torch.transcode(
                    x, dst, src_format=src, strategy="blockparallel")),
                ("scan blockparallel", lambda: repro_torch.scan(
                    x, dst, src_format=src, strategy="blockparallel"))):
            ms = cuda_ms(fn, reps=reps)
            out[label] = {"ms": ms, "GB_per_s_in": n / ms / 1e6}
        return out

    def time_ragged(x, offsets, lengths, src, dst, reps, plain_reps):
        """Each ragged kernel's wrapper and its plain version on a packed
        batch (strict, validate), with the bytes bound of the function:
        the input once, the output of ``cap`` units once, and per tile
        12 bytes of ownership read plus the per-tile scalars (12 bytes
        out of rcount and ronepass, 4 bytes of base into rwrite)."""
        own, span = ownership(x, offsets, lengths)
        nblk = span // BLOCK
        cap = tc.CAP_FACTOR[(src, dst)] * span
        in_bytes = x.shape[0] * x.element_size()
        out_bytes = cap * np.dtype(NP_DTYPE[dst]).itemsize
        kw = dict(src=src, dst=dst, errors="strict")
        base, _ = compaction.tile_base_offsets(
            rt.rcount_kernel(x, own, validate=True, **kw)[0])
        calls = {
            "rcount": (lambda: rt.rcount_kernel(x, own, validate=True, **kw),
                       lambda: rt.rcount_plain(x, own, validate=True, **kw),
                       in_bytes + 24 * nblk),
            "rwrite": (lambda: rt.rwrite_kernel(x, own, base, cap, **kw),
                       lambda: rt.rwrite_plain(x, own, base, cap, **kw),
                       in_bytes + 16 * nblk + out_bytes),
            "ronepass": (lambda: rt.ronepass_kernel(x, own, cap,
                                                    validate=True, **kw),
                         lambda: rt.ronepass_plain(x, own, cap,
                                                   validate=True, **kw),
                         in_bytes + 24 * nblk + out_bytes),
        }
        out = {}
        for name, (kern_fn, plain_fn, nbytes) in calls.items():
            hold(name, kern_fn(), plain_fn(), max_err, "timed ragged", src,
                 dst)
            ms = cuda_ms(kern_fn, reps=reps)
            out[name] = {"ms": ms, "device_ms": device_ms(kern_fn, reps),
                         "plain_ms": cuda_ms(plain_fn, reps=plain_reps,
                                             warmup=1),
                         "bound_ms": nbytes / roofline.HBM_BW * 1e3,
                         "bytes": nbytes, "GB_per_s": nbytes / ms / 1e6}
        return out

    timing = {"64MiB arabic utf8->utf16": {
        "kernels": time_kernels(x_main, "utf8", "utf16", 10, 3),
        "entry": entry_ms(x_main, "utf8", "utf16", 10)}}
    main_t = timing["64MiB arabic utf8->utf16"]
    rag_label = f"ragged {RAGGED_DOCS} docs utf8->utf16"
    rag_in = int(pk.lengths.sum())
    rag_entry = {}
    for label, fn in rag_calls.items():
        ms = cuda_ms(fn, reps=10)
        rag_entry[label] = {"ms": ms, "GB_per_s_in": rag_in / ms / 1e6}
    timing[rag_label] = {
        "kernels": time_ragged(x_rag, pk.offsets, pk.lengths, "utf8",
                               "utf16", 10, 3),
        "entry": rag_entry}
    rag_t = timing[rag_label]

    # The legacy kernels at the main path's shapes: the 64 MiB buffer,
    # and its 37.7 M-unit UTF-16 transcode for the encode kernel.  Bytes
    # bound: the input once, the int32 planes once, 4 bytes per tile.
    n16 = u16_main.shape[0]
    nblk8, nblk16 = main_bytes // BLOCK, -(-n16 // BLOCK)
    legacy_calls = {
        "validate": (lambda: kval.validate_kernel(x_main, main_bytes),
                     lambda: kval.validate_plain(x_main, main_bytes),
                     main_bytes + 4 * nblk8),
        "decode": (lambda: kdec.decode_kernel(x_main, main_bytes),
                   lambda: kdec.decode_plain(x_main, main_bytes),
                   main_bytes + 12 * main_bytes + 4 * nblk8),
        "encode": (lambda: kenc.encode_kernel(u16_main, n16),
                   lambda: kenc.encode_plain(u16_main, n16),
                   2 * n16 + 20 * n16 + 4 * nblk16),
    }
    legacy_t = {}
    for name, (kern_fn, plain_fn, nbytes) in legacy_calls.items():
        hold(name, kern_fn(), plain_fn(), max_err, "timed legacy")
        ms = cuda_ms(kern_fn, reps=10)
        legacy_t[name] = {"ms": ms, "device_ms": device_ms(kern_fn, 10),
                          "plain_ms": cuda_ms(plain_fn, reps=3, warmup=1),
                          "bound_ms": nbytes / roofline.HBM_BW * 1e3,
                          "bytes": nbytes, "GB_per_s": nbytes / ms / 1e6}
    # The validation kernel on 64 MiB of each class of its dispatch: the
    # latin (all tiles ASCII), arabic (<=2-byte) and chinese (general)
    # profiles.
    validate_rng = np.random.default_rng([args.seed, 3])
    validate_t = {}
    for lang in ("latin", "arabic", "chinese"):
        host8 = x8 if lang == "arabic" else inputs.utf8_buffer(
            lang, main_bytes, validate_rng)
        xv = torch.from_numpy(host8).cuda()
        want = kval.validate_plain(xv, main_bytes)
        require(equal(kval.validate_classes(xv, main_bytes), want),
                "validate_classes vs plain", lang)
        hold("validate", kval.validate_kernel(xv, main_bytes), want, max_err,
             "timed validate", lang)
        call = lambda: kval.validate_kernel(xv, main_bytes)  # noqa: E731
        ms = cuda_ms(call, reps=10)
        validate_t[lang] = {
            "ms": ms, "device_ms": device_ms(call, 10),
            "bound_ms": legacy_t["validate"]["bound_ms"],
            "tiles": class_counts(stages, "utf8", torch.from_numpy(host8))}
        log(f"phase 4: validate 64 MiB {lang:8s} {ms:.4f} ms a call "
            f"({validate_t[lang]['device_ms']:.4f} ms on the device)  bound "
            f"{validate_t[lang]['bound_ms']:.4f} ms  tiles "
            f"{validate_t[lang]['tiles']}  [{smi}]")
        del xv
    legacy_entry = {}
    for label, fn in (
            ("validate_utf8", lambda: ops.validate_utf8(x_main)),
            ("decode_utf8", lambda: ops.decode_utf8(x_main)),
            ("utf8_to_utf16", lambda: ops.utf8_to_utf16(x_main)),
            ("utf16_to_utf8", lambda: ops.utf16_to_utf8(u16_main))):
        legacy_entry[label] = {"ms": cuda_ms(fn, reps=10)}
    timing["legacy ops, 64MiB arabic utf8 / its utf16"] = {
        "kernels": legacy_t, "entry": legacy_entry,
        "validate by class": validate_t}
    for name, t in legacy_t.items():
        log(f"phase 4: legacy {name:8s} {t['ms']:.4f} ms "
            f"({t['GB_per_s']:.1f} GB/s; device {t['device_ms']:.4f} ms)  "
            f"bound {t['bound_ms']:.4f} ms  "
            f"plain {t['plain_ms']:.3f} ms  [{smi}]")
    for name, t in legacy_entry.items():
        log(f"phase 4: ops.{name:14s} {t['ms']:.4f} ms  [{smi}]")

    # Flash attention: kernel, plain version and, as the library
    # yardstick, scaled_dot_product_attention on the same inputs (moved
    # to its (B, H, S, D) layout before timing; a boolean mask for the
    # window).
    flash_t = {}
    for label, (q, k, v, window, dt) in flash_in.items():
        s_len, d = q.shape[1], q.shape[3]
        bound_ms, bound_by, flops = flash_bound(s_len, d, window, dt)
        ms = cuda_ms(lambda: fa.flash_kernel(q, k, v, window), reps=5)
        plain_ms = cuda_ms(lambda: fa.flash_plain(q, k, v, window), reps=3,
                           warmup=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if window is None:
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True)
        else:
            pos = torch.arange(s_len, device="cuda")
            mask = (pos[None] <= pos[:, None]) & (pos[:, None] - pos[None]
                                                  < window)
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask)
        library_ms = cuda_ms(sdpa, reps=5)
        lib_diff = (sdpa().transpose(1, 2).float()
                    - fa.flash_kernel(q, k, v, window).float()).abs().max()
        flash_t[label] = {"ms": ms, "plain_ms": plain_ms,
                          "device_ms": device_ms(lambda: fa.flash_kernel(
                              q, k, v, window), 5),
                          "library_ms": library_ms,
                          "library_device_ms": device_ms(sdpa, 5),
                          "bound_ms": bound_ms,
                          "bound_by": bound_by,
                          "bound_label": BOUND_LABEL[dt] if bound_by
                          == "operations" else bound_by, "flops": flops,
                          "TFLOP_per_s": flops / ms / 1e9,
                          "max_abs_diff_vs_library": lib_diff.item()}
        log(f"phase 4: flash {label:34s} {ms:.3f} ms ({flops / ms / 1e9:.1f} "
            f"TFLOP/s)  bound {bound_ms:.4f} ms "
            f"({flash_t[label]['bound_label']})  plain "
            f"{plain_ms:.3f} ms  sdpa {library_ms:.3f} ms; device: kernel "
            f"{flash_t[label]['device_ms']:.3f}, sdpa "
            f"{flash_t[label]['library_device_ms']:.3f} ms (max |diff| "
            f"{lib_diff.item():.3g})  [{smi}]")
        del qt, kt, vt
    timing["flash attention"] = flash_t

    # The windowed walks at 1<<17 characters of each profile: the kernel
    # (ms a call, device_ms, and device time per step of the walk), and
    # the entry point with its first-error pass (the count kernel).  The
    # bytes bound: the input once, the int32 output buffer once, the 16
    # KiB window table (UTF-8) and 12 bytes of scalars; the step-latency
    # bound: the walk's steps times the walker's chain at the SM's
    # maximum clock (step_bound_ms).  On the arabic profile, the kernels'
    # line: also the plain version (one call), held equal.
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    windowed_t, win_lines = {}, {}
    for (lang, src), x in win_in.items():
        dst = dict(WINDOWED)[src]
        kern, plain, first_error = walks[src]
        name = f"windowed_{src}"
        n = x.shape[0]
        status0 = first_error(win.masked_int32(x, n), n)
        call = lambda: kern(x, n, status0, True)  # noqa: E731
        out_bytes = 4 * (win.utf8_capacity(n) if src == "utf8"
                         else win.utf16_capacity(n))
        nbytes = n * x.element_size() + out_bytes + 12 + (
            4 << 12 if src == "utf8" else 0)
        ms = cuda_ms(call, reps=5)
        t = {"ms": ms, "device_ms": device_ms(call, 5),
             "entry_ms": cuda_ms(lambda: repro_torch.transcode(
                 x, dst, src_format=src, strategy="windowed"), reps=5),
             "fused_entry_ms": cuda_ms(lambda: repro_torch.transcode(
                 x, dst, src_format=src, strategy="fused"), reps=5),
             "input_bytes": n * x.element_size(),
             "bound_ms": nbytes / roofline.HBM_BW * 1e3, "bytes": nbytes}
        t["GB_per_s_in"] = t["input_bytes"] / t["device_ms"] / 1e6
        units = x.cpu().numpy()
        t["steps"] = walk_steps(src, units)
        t["ns_per_step"] = t["device_ms"] * 1e6 / t["steps"]
        t["step_bound_ms"] = step_bound_ms(src, units, clock_mhz)
        t["clock_max_mhz"] = clock_mhz
        if lang == "arabic":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = plain(x, n, status0, True)
            end.record()
            end.synchronize()
            t["plain_ms"] = start.elapsed_time(end)
            hold(name, call(), want, max_err, "timed", lang)
            win_lines[name] = t
        windowed_t[f"{lang} {src}->{dst}"] = t
        log(f"phase 4: windowed {lang:9s} {src}->{dst} {LIPSUM_CHARS} chars "
            f"({t['input_bytes']} B): kernel {ms:.3f} ms a call, "
            f"{t['device_ms']:.3f} ms on the device "
            f"({t['GB_per_s_in']:.3f} GB/s of input; {t['steps']} steps, "
            f"{t['ns_per_step']:.1f} ns a step), bound "
            f"{t['bound_ms']:.4f} ms (bytes), {t['step_bound_ms']:.4f} ms "
            f"(steps x chain at {clock_mhz:.0f} MHz); transcode windowed "
            f"{t['entry_ms']:.3f} ms, fused {t['fused_entry_ms']:.4f} ms  "
            f"[{smi}]")
    timing[f"windowed {LIPSUM_CHARS} chars"] = windowed_t

    # The data path: next_batch a step (host clock, ending in a
    # synchronise), and batch_transcode packed and vmap (one call between
    # CUDA events).
    t0 = time.time()
    for _ in range(PIPE_STEPS):
        pipe_card.next_batch()
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) / PIPE_STEPS * 1e3
    data_t = {"next_batch_ms_per_step": step_ms,
              "pipeline_bytes_per_step": PIPE["seq_len"]
              * PIPE["global_batch"]}
    for strategy, reps in (("packed", 5), ("vmap", 2)):
        data_t[f"batch_transcode {strategy} ms"] = cuda_ms(
            lambda: dp.batch_transcode(bt_x, bt_lens, strategy=strategy),
            reps=reps, warmup=1)
    timing["data path"] = data_t
    log(f"phase 4: TextPipeline next_batch {step_ms:.1f} ms a step "
        f"({PIPE['global_batch']} x {PIPE['seq_len']} B, emit codepoints; "
        f"host clock)  [{smi}]")
    log(f"phase 4: batch_transcode [{BATCH_DOCS}, {BATCH_LEN}] utf8->utf16 "
        f"packed {data_t['batch_transcode packed ms']:.3f} ms, vmap "
        f"{data_t['batch_transcode vmap ms']:.1f} ms  [{smi}]")

    # -- 5. the models, and 6. the serve engine over phase 5's qwen3-8b ------
    report["model"], model_launches, model = model_phase(
        rng, smi, zero_counts, read_counts)
    report["engine"], engine_launches, served = engine_phase(
        model, np.random.default_rng([args.seed, 4]), smi, zero_counts,
        read_counts, faults)
    # -- 7. the sharded path, the engine's on phase 5's qwen3-8b too -------
    report["shard"], shard_launches = shard_phase(
        model, served, docs, pk, x8, text_cps,
        np.random.default_rng([args.seed, 7]), smi, zero_counts,
        read_counts, faults, Path(args.out).parent)
    del model
    torch.cuda.empty_cache()
    # -- 8. training ---------------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as work:
        report["train"], train_launches = train_phase(
            np.random.default_rng([args.seed, 8]), smi, zero_counts,
            read_counts, Path(work))
    from repro_torch import configs
    danube = {"cfg": configs.get_config(DANUBE_ARCH),
              "batch": report["train"].pop("_danube_batch"),
              "seed": report["train"][DANUBE_ARCH]["seed"],
              "steps": report["train"][DANUBE_ARCH]["steps"]}
    for name, count in [*model_launches.items(), *engine_launches.items(),
                        *shard_launches.items(), *train_launches.items()]:
        launches[name] = launches.get(name, 0) + count
    # -- 9. the analysis stack ---------------------------------------------
    kw = dict(src="utf8", dst="utf16", errors="strict")
    n8, n16 = x_main.shape[0], u16_main.shape[0]
    cap8 = tc.CAP_FACTOR[("utf8", "utf16")] * n8
    base8, _ = compaction.tile_base_offsets(
        ft.count_kernel(x_main, n8, validate=True, **kw)[0])
    own, span = ownership(x_rag, pk.offsets, pk.lengths)
    capr = tc.CAP_FACTOR[("utf8", "utf16")] * span
    baser, _ = compaction.tile_base_offsets(
        rt.rcount_kernel(x_rag, own, validate=True, **kw)[0])
    kernel_calls = {
        "count": lambda: ft.count_kernel(x_main, n8, validate=True, **kw),
        "write": lambda: ft.write_kernel(x_main, n8, base8, cap8, **kw),
        "onepass": lambda: op.onepass_kernel(x_main, n8, cap8,
                                             validate=True, **kw),
        "rcount": lambda: rt.rcount_kernel(x_rag, own, validate=True, **kw),
        "rwrite": lambda: rt.rwrite_kernel(x_rag, own, baser, capr, **kw),
        "ronepass": lambda: rt.ronepass_kernel(x_rag, own, capr,
                                               validate=True, **kw),
        "validate": lambda: kval.validate_kernel(x_main, n8),
        "decode": lambda: kdec.decode_kernel(x_main, n8),
        "encode": lambda: kenc.encode_kernel(u16_main, n16),
    }
    table_bytes = {name: t["bytes"] for name, t in [
        *main_t["kernels"].items(), *rag_t["kernels"].items(),
        *legacy_t.items()]}
    report["analysis"] = analysis_phase(report, smi, kernel_calls,
                                        table_bytes, Path(args.out).parent)
    # -- 10. multi-rank training ---------------------------------------------
    # the rank processes share the card: hand back what this one cached
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as work:
        report["multirank"] = multirank_phase(smi, Path(work), danube=danube)
    for label in ("2x2", "4x1", "1x4"):
        for r in report["multirank"][label]["ranks"]:
            for name, count in r["launches"].items():
                if count:
                    launches[name] = launches.get(name, 0) + count

    lines = []
    main_flash = flash_t[FLASH_MAIN[0][0]]
    sources = {"flash": FLASH_SOURCE, "windowed_utf8": WINDOWED_SOURCE,
               "windowed_utf16": WINDOWED_SOURCE}
    for name, t in [*main_t["kernels"].items(), *rag_t["kernels"].items(),
                    *legacy_t.items(), ("flash", main_flash),
                    *win_lines.items()]:
        lines.append({
            "name": name, "route": "cuda",
            "source": sources.get(name, SOURCE),
            "replaces": REPLACES[name], "launches": launches[name],
            "bit_identical": max_err[name] == 0,
            "max_abs_err": max_err[name], "ms": t["ms"],
            "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t.get("bound_by", "bytes"),
            "library_ms": t.get("library_ms"),
            **({"step_bound_ms": t["step_bound_ms"]}
               if "step_bound_ms" in t else {})})
    for name, t in main_t["kernels"].items():
        log(f"phase 4: 64 MiB arabic utf8->utf16 {name:8s} {t['ms']:.4f} ms "
            f"({t['GB_per_s']:.1f} GB/s; device {t['device_ms']:.4f} ms)  "
            f"bound {t['bound_ms']:.4f} ms  "
            f"plain {t['plain_ms']:.3f} ms  tiles {main_classes}  [{smi}]")
    for name, t in main_t["entry"].items():
        log(f"phase 4: 64 MiB arabic utf8->utf16 {name:18s} {t['ms']:.4f} ms "
            f"({t['GB_per_s_in']:.1f} GB/s of input)  [{smi}]")
    for name, t in rag_t["kernels"].items():
        log(f"phase 4: {rag_label} {name:8s} {t['ms']:.4f} ms "
            f"({t['GB_per_s']:.1f} GB/s; device {t['device_ms']:.4f} ms)  "
            f"bound {t['bound_ms']:.4f} ms  "
            f"plain {t['plain_ms']:.3f} ms  tiles {rag_classes}  [{smi}]")
    for name, t in rag_t["entry"].items():
        log(f"phase 4: {rag_label} {name:22s} {t['ms']:.4f} ms "
            f"({t['GB_per_s_in']:.1f} GB/s of input)  [{smi}]")
    for lang in inputs.PROFILES:
        cps = inputs.codepoints(lang, LIPSUM_CHARS, rng)
        for src, dst in (("utf8", "utf16"), ("utf16", "utf8")):
            x = torch.from_numpy(encode(cps, src)).cuda()
            cell = {"input_bytes": x.numel() * x.element_size(),
                    "kernels": time_kernels(x, src, dst, 20, 5),
                    "entry": entry_ms(x, src, dst, 20)}
            timing[f"{lang} {src}->{dst} {LIPSUM_CHARS} chars"] = cell
            k, e = cell["kernels"], cell["entry"]
            log(f"phase 4: {lang:9s} {src}->{dst} {LIPSUM_CHARS} chars "
                f"({cell['input_bytes']} B)  kernels ms (bound, plain): "
                + "  ".join(f"{nm} {t['ms']:.4f} ({t['bound_ms']:.4f}, "
                            f"{t['plain_ms']:.3f})" for nm, t in k.items())
                + "  entry ms: "
                + "  ".join(f"{nm} {t['ms']:.4f}" for nm, t in e.items())
                + f"  [{smi}]")
    report["timing"] = timing
    report["kernels"] = lines
    report["seconds"] = time.time() - t_start

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    log(f"report written to {out} ({report['seconds']:.0f} s)")
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
