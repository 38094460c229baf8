"""Synthetic multilingual corpora mirroring the paper's Table 4 datasets.

The paper benchmarks on lipsum files whose defining property is the mix of
UTF-8 byte lengths per character (1/2/3/4).  We reproduce those mixes with
seeded generators drawing code points from the real Unicode blocks of each
language, so the transcoder benchmarks stress exactly the same code paths
(ASCII fast path, 2-byte Arabic/Hebrew/Russian, 3-byte CJK, 4-byte emoji).

Port of ``repro.data.synthetic``, numpy only and unchanged, so that both
packages draw the same corpora in one process.  As in the reference,
:func:`generate_codepoints` salts its seed with ``hash(lang)``, which
Python salts per process (``PYTHONHASHSEED``): a corpus is the same
within a process, not across processes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Code-point pools per UTF-8 byte-length class, per script.
_ASCII = (0x20, 0x7E)
_POOLS = {
    "arabic2": (0x0621, 0x064A),
    "hebrew2": (0x05D0, 0x05EA),
    "cyrillic2": (0x0410, 0x044F),
    "latin2": (0x00C0, 0x00FF),
    "greek2": (0x0391, 0x03C9),
    "cjk3": (0x4E00, 0x9FA5),
    "kana3": (0x3041, 0x30FE),
    "hangul3": (0xAC00, 0xD7A3),
    "devanagari3": (0x0901, 0x0963),
    "thai3": (0x0E01, 0x0E5B),
    "emoji4": (0x1F300, 0x1F6FF),
}


@dataclasses.dataclass(frozen=True)
class LangProfile:
    """Byte-length percentages (Table 4a) + code-point pools per class."""
    name: str
    pct: tuple  # (1-byte, 2-byte, 3-byte, 4-byte), sums to 100
    pool2: str = "latin2"
    pool3: str = "cjk3"


# Table 4 (a), lipsum datasets: percentage of characters per UTF-8 length.
LANG_PROFILES = {
    "arabic": LangProfile("arabic", (22, 78, 0, 0), pool2="arabic2"),
    "chinese": LangProfile("chinese", (1, 0, 99, 0)),
    "emoji": LangProfile("emoji", (0, 0, 0, 100)),
    "hebrew": LangProfile("hebrew", (22, 78, 0, 0), pool2="hebrew2"),
    "hindi": LangProfile("hindi", (16, 0, 84, 0), pool3="devanagari3"),
    "japanese": LangProfile("japanese", (5, 0, 95, 0), pool3="kana3"),
    "korean": LangProfile("korean", (27, 1, 72, 0), pool3="hangul3"),
    "latin": LangProfile("latin", (100, 0, 0, 0)),
    "russian": LangProfile("russian", (19, 81, 0, 0), pool2="cyrillic2"),
}

# Table 4 (b), wikipedia-Mars: much more ASCII-heavy mixes.
WIKI_PROFILES = {
    "arabic": LangProfile("arabic", (75, 25, 0, 0), pool2="arabic2"),
    "chinese": LangProfile("chinese", (84, 1, 15, 0)),
    "czech": LangProfile("czech", (95, 5, 0, 0)),
    "english": LangProfile("english", (100, 0, 0, 0)),
    "french": LangProfile("french", (98, 2, 0, 0)),
    "greek": LangProfile("greek", (74, 26, 0, 0), pool2="greek2"),
    "hebrew": LangProfile("hebrew", (71, 29, 0, 0), pool2="hebrew2"),
    "hindi": LangProfile("hindi", (78, 0, 22, 0), pool3="devanagari3"),
    "japanese": LangProfile("japanese", (80, 1, 19, 0), pool3="kana3"),
    "korean": LangProfile("korean", (82, 1, 17, 0), pool3="hangul3"),
    "russian": LangProfile("russian", (70, 30, 0, 0), pool2="cyrillic2"),
    "thai": LangProfile("thai", (77, 0, 23, 0), pool3="thai3"),
}


def _sample_codepoints(profile: LangProfile, n_chars: int,
                       rng: np.random.Generator) -> np.ndarray:
    p = np.asarray(profile.pct, np.float64)
    p = p / p.sum()
    cls = rng.choice(4, size=n_chars, p=p)
    cp = np.empty(n_chars, np.int64)
    pools = [_ASCII, _POOLS[profile.pool2], _POOLS[profile.pool3],
             _POOLS["emoji4"]]
    for k in range(4):
        m = cls == k
        lo, hi = pools[k]
        cp[m] = rng.integers(lo, hi + 1, size=int(m.sum()))
    # space word boundaries roughly every 6 chars keeps text realistic
    # without disturbing the ASCII share materially for non-latin scripts.
    return cp


def generate_codepoints(lang: str, n_chars: int, seed: int = 0,
                        profiles=None) -> np.ndarray:
    profiles = profiles or LANG_PROFILES
    rng = np.random.default_rng(seed + hash(lang) % (1 << 31))
    return _sample_codepoints(profiles[lang], n_chars, rng)


def generate_utf8(lang: str, n_chars: int, seed: int = 0,
                  profiles=None) -> bytes:
    cp = generate_codepoints(lang, n_chars, seed, profiles)
    return "".join(map(chr, cp)).encode("utf-8")


def generate_utf16le(lang: str, n_chars: int, seed: int = 0,
                     profiles=None) -> bytes:
    cp = generate_codepoints(lang, n_chars, seed, profiles)
    return "".join(map(chr, cp)).encode("utf-16-le")


def utf8_array(lang: str, n_chars: int, seed: int = 0) -> np.ndarray:
    """uint8 numpy array of UTF-8 bytes (the benchmark/pipeline input)."""
    return np.frombuffer(generate_utf8(lang, n_chars, seed), np.uint8)


def utf16_units(lang: str, n_chars: int, seed: int = 0) -> np.ndarray:
    """uint16 numpy array of UTF-16LE code units."""
    return np.frombuffer(generate_utf16le(lang, n_chars, seed), np.uint16)
