// Hand-written Hopper (sm_90a) kernels of the single-buffer and the
// ragged packed-batch transcode.
//
// Three kernels, one source, templated on the (source, destination)
// format pair, the 12 cells of the {utf8, utf16, utf32, latin1} matrix,
// and on the tile geometry: Flat (one buffer of n live elements) or
// Packed (a batch of documents packed at tile-aligned offsets, with
// per-tile ownership arrays).  errors= ("replace" or "strict") and
// validate are runtime arguments.
//
//   count_kernel<Flat>      replaces src/repro/kernels/fused_transcode.py::_count_kernel
//                           per tile: decode, destination lengths and
//                           validation, reduced to (total, err_flag,
//                           first_error).
//   write_kernel<Flat>      replaces src/repro/kernels/fused_transcode.py::_write_kernel
//                           per tile: re-decode and store the live units
//                           at base[tile] + in-tile rank; zeros past the
//                           output's end (no zero-fill pass).
//   onepass_kernel<Flat>    replaces src/repro/kernels/onepass_transcode.py::_onepass_kernel
//                           count and write off one decode, the
//                           inter-tile offset carried by a decoupled
//                           look-back, one per warp-tile;
//                           onepass_tail_kernel, launched behind it,
//                           zeroes the output past the count.
//   count_kernel<Packed>    replaces src/repro/kernels/ragged_transcode.py::_rcount_kernel
//   write_kernel<Packed>    replaces src/repro/kernels/ragged_transcode.py::_rwrite_kernel
//   onepass_kernel<Packed>  replaces src/repro/kernels/ragged_transcode.py::_ronepass_kernel
//                           the same bodies over a packed batch: a tile
//                           reads its neighbour tiles only when they
//                           belong to its own document, and its live end
//                           is its document's end.  The look-back's
//                           global offset is the per-document segment
//                           scan, since documents are packed in order;
//                           the one-pass kernel writes per-tile (total,
//                           err, first_error) for the per-document reduce.
//
// All three run one warp per 1024-element tile, the tile in registers
// (load_lane), and dispatch on the tile's class (tile_class: ASCII, the
// <=2-byte class, the general body; the reference's per-tile dispatch,
// src/repro/kernels/stages/driver.py::onepass_tile).  The write and
// one-pass kernels compact each tile's units in the warp's region of
// shared memory and store them with 16-byte stores (copy_out; the
// one-pass kernels stage before their offset is known and realign on
// the way out, copy_out_shifted).
//
// Three more kernels carry the legacy kernel surface (kernels/ops.py);
// they are templated on the input element type (uint8, uint16 or int32)
// and have no dependence across blocks:
//
//   validate_kernel       replaces src/repro/kernels/utf8_validate.py::utf8_validate_kernel
//                         per tile: the Keiser-Lemire maximum of sc ^ must;
//                         one warp per tile, dispatched on the tile's
//                         class, the tables in registers.
//   decode_kernel         replaces src/repro/kernels/utf8_decode.py::utf8_decode_kernel
//                         per lane: the legacy speculative decode (cp,
//                         lead, units) and per tile its error flag.
//   encode_kernel         replaces src/repro/kernels/utf16_encode.py::utf16_encode_kernel
//                         per lane: surrogate folding, four candidate
//                         UTF-8 byte planes and the length; per tile the
//                         unpaired-surrogate flag.
//
// What bounds them on the card: the bytes they must move, (bytes read +
// bytes written) / 3.35 TB/s, is the least time (no tensor-core work, and
// the card's table of peak rates has no int32 rate).  The design answers
// that by reading each input element from device memory once per pass,
// widening to int32 only in registers, and storing only live output
// units, narrowed to the destination type; the count kernel writes 12
// bytes per 1024-element tile.  The lane bodies are tens of integer
// instructions per element, well above the int32 ALU's few operations
// per byte of memory bandwidth, so instruction issue, not memory, sets
// the time (PERF.md).  The transcode kernels answer that with the
// reference's per-tile classes, whose ASCII tiles run no lane body and
// whose <=2-byte tiles run a short one, and with registers in place of a
// staged tile.  Every transcode kernel that validates reads the
// Keiser-Lemire nibble tables from its block's shared-memory copy; the
// validation kernel holds them in registers as bytes (validate_kernel).
//
// Semantics are lane for lane those of the reference tile bodies
// (src/repro/kernels/stages/*.py and src/repro/core/{utf8,utf16}.py):
// int32 lanes, arithmetic shifts, and the same select trees.  The TPU
// kernels stored a whole stage window (slack included) at base[tile] and
// relied on the sequential grid to let the next tile overwrite the slack;
// here each tile stores only its own units, and only below cap, which
// gives the same bytes with no race.  Every output is allocated
// uninitialised: the write kernel also writes the zeros past the
// output's end, onepass_tail_kernel those past the one-pass count.
//
// The C entry points return cudaGetLastError() after the launch; the
// Python wrappers raise when it is not 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 1024;               // elements per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int IMAX = 0x7fffffff;         // no-error sentinel
constexpr int STATUS_OK = -1;

enum Format { UTF8 = 0, UTF16 = 1, UTF32 = 2, LATIN1 = 3 };

template <int F> struct Storage;
template <> struct Storage<UTF8> { using T = uint8_t; };
template <> struct Storage<UTF16> { using T = uint16_t; };
template <> struct Storage<UTF32> { using T = uint32_t; };
template <> struct Storage<LATIN1> { using T = uint8_t; };

// How far a lane's result reads its neighbours, each way: UTF-8 reads
// three bytes back (claims, Keiser-Lemire) and three ahead (assembly);
// UTF-16 one unit each way (pairs); the fixed-width formats none.
template <int F> struct Reach { static constexpr int value = 0; };
template <> struct Reach<UTF8> { static constexpr int value = 3; };
template <> struct Reach<UTF16> { static constexpr int value = 1; };

// Keiser-Lemire nibble tables (byte_1_high, byte_1_low, byte_2_high, 16
// entries each), loaded by transcode_set_tables from
// src/repro_torch/core/tables.py.  The transcode kernels' lane bodies
// never read them here: each block copies them to shared memory
// (load_kl_tables), since lanes of a warp that look up different
// constant-memory addresses serialise.  Only validate_kernel's body for
// int32 input outside the byte range, off every main path, reads them
// here.
constexpr int KL_ENTRIES = 48;
__constant__ int32_t kKL[KL_ENTRIES];

// The block's shared copy of kKL; the caller's next __syncthreads
// publishes it.
__device__ __forceinline__ void load_kl_tables(int32_t* tab) {
  static_assert(KL_ENTRIES <= THREADS, "a thread an entry");
  if (threadIdx.x < KL_ENTRIES) tab[threadIdx.x] = kKL[threadIdx.x];
}

struct Analysis {
  bool starts;   // lane begins a unit
  bool valid;    // the unit is a valid character
  int32_t cp;    // code point (U+FFFD at invalid starts, 0 elsewhere)
  bool err;      // unit start that is not a valid character
};

struct Lane {
  int32_t cp;     // code point the lane encodes
  int32_t units;  // destination units it emits (0 at dead lanes)
  bool sub;       // located error: maximal subpart or unencodable scalar
  bool err;       // sub, or the Keiser-Lemire detector
};

// ---------------------------------------------------------------------------
// UTF-8 source (src/repro/kernels/stages/utf8.py, core/utf8.py).

__device__ __forceinline__ int utf8_lead_len_strict(int b) {
  return b < 0x80 ? 1
       : (b >= 0xC2 && b < 0xE0) ? 2
       : (b >= 0xE0 && b < 0xF0) ? 3
       : (b >= 0xF0 && b < 0xF5) ? 4 : 0;
}

__device__ __forceinline__ bool utf8_first_cont_ok(int lead, int c) {
  const int lo = lead == 0xE0 ? 0xA0 : (lead == 0xF0 ? 0x90 : 0x80);
  const int hi = lead == 0xED ? 0x9F : (lead == 0xF4 ? 0x8F : 0xBF);
  return c >= lo && c <= hi;
}

__device__ __forceinline__ int32_t utf8_assemble(int len, int b, int n1,
                                                 int n2, int n3) {
  if (len == 2) return ((b & 0x1F) << 6) | (n1 & 0x3F);
  if (len == 3) return ((b & 0x0F) << 12) | ((n1 & 0x3F) << 6) | (n2 & 0x3F);
  return ((b & 0x07) << 18) | ((n1 & 0x3F) << 12) | ((n2 & 0x3F) << 6) |
         (n3 & 0x3F);
}

__device__ __forceinline__ Analysis utf8_analyze(const int32_t* s) {
  const int p3 = s[-3], p2 = s[-2], p1 = s[-1], b = s[0];
  const int n1 = s[1], n2 = s[2], n3 = s[3];
  const int L = utf8_lead_len_strict(b);
  const bool c1ok = utf8_first_cont_ok(b, n1);
  const bool c2ok = (n2 & 0xC0) == 0x80;
  const bool c3ok = (n3 & 0xC0) == 0x80;
  bool valid = L == 1 || (L == 2 && c1ok) || (L == 3 && c1ok && c2ok) ||
               (L == 4 && c1ok && c2ok && c3ok);
  const bool is_cont = (b & 0xC0) == 0x80;
  const bool cont_p1 = (p1 & 0xC0) == 0x80;
  const bool claimed =
      (utf8_lead_len_strict(p1) >= 2 && utf8_first_cont_ok(p1, b)) ||
      (utf8_lead_len_strict(p2) >= 3 && utf8_first_cont_ok(p2, p1) &&
       is_cont) ||
      (utf8_lead_len_strict(p3) == 4 && utf8_first_cont_ok(p3, p2) &&
       cont_p1 && is_cont);
  const bool starts = !claimed;
  valid = starts && valid;
  int32_t cp = L <= 1 ? b : utf8_assemble(L, b, n1, n2, n3);
  cp = valid ? cp : 0xFFFD;
  cp = starts ? cp : 0;
  return {starts, valid, cp, starts && !valid};
}

__device__ __forceinline__ void utf8_decode(const int32_t* s, int32_t& cp,
                                            bool& lead) {
  const int b = s[0];
  const int len = b < 0x80 ? 1 : b < 0xC0 ? 0 : b < 0xE0 ? 2
                : b < 0xF0 ? 3 : b < 0xF8 ? 4 : 0;
  lead = len > 0;
  cp = !lead ? 0 : len == 1 ? b : utf8_assemble(len, b, s[1], s[2], s[3]);
}

// tab is the block's shared copy of kKL.  In the <=2-byte class no byte
// reaches 0xE0, so must_be_cont is 0.
template <bool C2>
__device__ __forceinline__ bool utf8_kl_error(const int32_t* s,
                                              const int32_t* tab) {
  const int p1 = s[-1];
  const int sc = tab[p1 >> 4] & tab[16 + (p1 & 0xF)] & tab[32 + (s[0] >> 4)];
  const int must_be_cont =
      (!C2 && (s[-2] >= 0xE0 || s[-3] >= 0xF0)) ? 0x80 : 0;
  return (sc ^ must_be_cont) != 0;
}

// The <=2-byte class (src/repro/kernels/stages/utf8.py analyze2 and
// decode2): every byte of the tile and of its 3-byte inflow is below
// 0xE0, so strict lead lengths are 0, 1 or 2, only the 2-byte claim
// survives and the first continuation's range is 80..BF.  Lanewise equal
// to utf8_analyze and utf8_decode on such a tile.
__device__ __forceinline__ Analysis utf8_analyze2(const int32_t* s) {
  const int p1 = s[-1], b = s[0], n1 = s[1];
  const int L = b < 0x80 ? 1 : (b >= 0xC2 && b < 0xE0) ? 2 : 0;
  const bool is_cont = (b & 0xC0) == 0x80;
  const bool starts = !(p1 >= 0xC2 && p1 <= 0xDF && is_cont);
  const bool c1ok = (n1 & 0xC0) == 0x80;
  const bool valid = starts && (L == 1 || (L == 2 && c1ok));
  int32_t cp = L == 2 ? ((b & 0x1F) << 6) | (n1 & 0x3F) : b;
  cp = valid ? cp : (starts ? 0xFFFD : 0);
  return {starts, valid, cp, starts && !valid};
}

__device__ __forceinline__ void utf8_decode2(const int32_t* s, int32_t& cp,
                                             bool& lead) {
  const int b = s[0];
  lead = b < 0x80 || b >= 0xC0;
  cp = !lead ? 0 : b < 0x80 ? b : ((b & 0x1F) << 6) | (s[1] & 0x3F);
}

// ---------------------------------------------------------------------------
// UTF-16 source (src/repro/kernels/stages/utf16.py, core/utf16.py).

__device__ __forceinline__ int32_t utf16_pair_cp(int u, int nxt) {
  return 0x10000 + ((u - 0xD800) << 10) + (nxt - 0xDC00);
}

__device__ __forceinline__ Analysis utf16_analyze(const int32_t* s) {
  const int p1 = s[-1], u = s[0], n1 = s[1];
  const bool is_hi = (u >> 10) == 0x36, is_lo = (u >> 10) == 0x37;
  const bool paired_hi = is_hi && (n1 >> 10) == 0x37;
  const bool starts = !(is_lo && (p1 >> 10) == 0x36);
  const bool valid = starts && (!(is_hi || is_lo) || paired_hi);
  int32_t cp = paired_hi ? utf16_pair_cp(u, n1) : u;
  cp = valid ? cp : 0xFFFD;
  cp = starts ? cp : 0;
  return {starts, valid, cp, starts && !valid};
}

__device__ __forceinline__ void utf16_decode(const int32_t* s, int32_t& cp,
                                             bool& lead) {
  const int p1 = s[-1], u = s[0];
  const bool is_hi = (u >> 10) == 0x36, is_lo = (u >> 10) == 0x37;
  cp = is_hi ? utf16_pair_cp(u, s[1]) : u;
  lead = !(is_lo && (p1 >> 10) == 0x36);
}

// ---------------------------------------------------------------------------
// Destination side (src/repro/kernels/stages/*.py encode_units).

__device__ __forceinline__ bool invalid_scalar(int32_t cp) {
  return (cp >= 0xD800 && cp < 0xE000) || cp > 0x10FFFF || cp < 0;
}

__device__ __forceinline__ bool latin1_bad(int32_t cp) {
  return cp < 0 || cp > 0xFF;
}

template <int D>
__device__ __forceinline__ int32_t unit_len(int32_t cp) {
  if constexpr (D == UTF8) {
    return 1 + (cp >= 0x80) + (cp >= 0x800) + (cp >= 0x10000);
  } else if constexpr (D == UTF16) {
    return 1 + (cp >= 0x10000);
  } else {
    return 1;
  }
}

// Unit j of code point cp in format D (j < unit_len<D>(cp)).
template <int D>
__device__ __forceinline__ int32_t encode_unit(int32_t cp, int j) {
  if constexpr (D == UTF8) {
    const int L = unit_len<UTF8>(cp);
    if (j == 0) {
      return L == 1 ? cp : L == 2 ? (0xC0 | (cp >> 6))
           : L == 3 ? (0xE0 | (cp >> 12)) : (0xF0 | ((cp >> 18) & 0x07));
    }
    // Continuation j carries bits [6 * (L - 1 - j), +6).
    return 0x80 | ((cp >> (6 * (L - 1 - j))) & 0x3F);
  } else if constexpr (D == UTF16) {
    if (cp < 0x10000) return cp;
    const int32_t v = cp - 0x10000;
    return j == 0 ? 0xD800 + (v >> 10) : 0xDC00 + (v & 0x3FF);
  } else if constexpr (D == UTF32) {
    return cp;
  } else {
    return latin1_bad(cp) ? 0x3F : cp;
  }
}

// ---------------------------------------------------------------------------
// One lane: the reference's decode_once + count_decoded/stage_decoded.
// C2 selects the <=2-byte class bodies (decode_once2), valid only on a
// tile of that class; UTF-16 and UTF-32 lanes of the class are their own
// code points, valid and leads.  tab, the block's Keiser-Lemire tables,
// is read only for a UTF-8 source under validate.

template <int S, int D, bool C2 = false>
__device__ __forceinline__ Lane eval_lane(const int32_t* s, bool live,
                                          bool replace, bool validate,
                                          const int32_t* tab) {
  const bool need_analysis = validate || replace;
  Analysis a{true, true, 0, false};
  int32_t cp = 0;
  bool lead = true;
  bool extra = false;
  if constexpr (S == UTF8) {
    if (need_analysis) a = C2 ? utf8_analyze2(s) : utf8_analyze(s);
    if (validate) extra = utf8_kl_error<C2>(s, tab);
    if (!replace) {
      if constexpr (C2) {
        utf8_decode2(s, cp, lead);
      } else {
        utf8_decode(s, cp, lead);
      }
    }
  } else if constexpr (C2) {
    a = {true, true, s[0], false};
    cp = s[0];
  } else if constexpr (S == UTF16) {
    if (need_analysis) a = utf16_analyze(s);
    if (!replace) utf16_decode(s, cp, lead);
  } else if constexpr (S == UTF32) {
    const bool bad = invalid_scalar(s[0]);
    a = {true, !bad, bad ? 0xFFFD : s[0], bad};
    cp = a.cp;
  } else {
    a = {true, true, s[0], false};
    cp = s[0];
  }
  if (replace) {
    cp = a.cp;
    lead = a.starts;
  }
  Lane r;
  r.cp = cp;
  r.units = (lead && live) ? unit_len<D>(cp) : 0;
  r.sub = false;
  r.err = false;
  if (validate && live) {
    r.sub = a.err || (D == LATIN1 && latin1_bad(a.cp) && a.starts);
    r.err = r.sub || extra;
  }
  return r;
}

// Tile geometry of a single buffer: n live elements.
struct Flat {
  static constexpr bool packed = false;
  int n;
  __device__ __forceinline__ int end(int) const { return n; }
  // Elements of the tile, and of the previous / next tile as its halo,
  // are read below these limits (and from 0 on); the rest read 0, like
  // the reference's zero boundary tiles and its padding mask.
  __device__ __forceinline__ int own_limit(int) const { return n; }
  __device__ __forceinline__ int prev_limit(int) const { return n; }
  __device__ __forceinline__ int next_limit(int) const { return n; }
};

// Tile geometry of a packed batch (src/repro_torch/core/packing.py): len
// elements of data in nblk tiles, and per tile the end of its document
// (tile_end) and whether the previous / next tile belongs to the same
// document (same_prev / same_next, 0 or 1).  An element of the tile is
// read only below its document's end; a halo element of tile t-1 or t+1
// only when that tile belongs to the same document and below that tile's
// end: the reference's _mask_to_docs followed by `xp * same_prev` / `xn *
// same_next`.  Trailing pad tiles clamp to the last document with
// same_prev = 1; only the per-neighbour end test keeps them out of the
// last live tile's next halo.
struct Packed {
  static constexpr bool packed = true;
  int len;
  int nblk;
  const int* tile_end;
  const int* same_prev;
  const int* same_next;
  __device__ __forceinline__ int end(int tile) const {
    return tile_end[tile];
  }
  __device__ __forceinline__ int own_limit(int tile) const {
    return min(len, tile_end[tile]);
  }
  __device__ __forceinline__ int prev_limit(int tile) const {
    return tile > 0 && same_prev[tile] ? min(len, tile_end[tile - 1]) : 0;
  }
  __device__ __forceinline__ int next_limit(int tile) const {
    return tile + 1 < nblk && same_next[tile] ? min(len, tile_end[tile + 1])
                                              : 0;
  }
};

__device__ __forceinline__ int status_from_first(int first, int err_any) {
  if (first != IMAX) return first;
  return err_any ? 0 : STATUS_OK;
}

// Strong (relaxed) 64-bit loads and stores at GPU scope: a store is seen
// by every SM's later loads, and a load reads past the SM's L1 cache.  The
// look-back's words carry their own data (the flag and the value in one
// word), so it needs no acquire or release: nothing else that a tile
// wrote is read through them (the one-pass kernels' error fold is read
// after the kernel has ended, by onepass_tail_kernel).
__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// ---------------------------------------------------------------------------
// The decoupled look-back of the one-pass kernels (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016), over
// the running output offset.
//
// state[t] packs a flag (bits 32-33) with a 32-bit unsigned value (low 32
// bits), so one 64-bit store publishes both and one 64-bit load reads
// both.  The wrappers zero-fill state, so 0 is NOT_READY.  Offsets
// are below 4 * MAX_ELEMENTS < 2**31 (runtime.py), so the value never
// reaches the flag bits.
constexpr unsigned long long FLAG_AGGREGATE = 1ull << 32;  // tile total
constexpr unsigned long long FLAG_INCLUSIVE = 2ull << 32;  // prefix + total

// Lane 0 of the warp that owns tile `tile` publishes its total: (AGGREGATE,
// total), or (INCLUSIVE, total) for tile 0, whose prefix is 0.
__device__ __forceinline__ void publish_total(unsigned long long* state,
                                              int tile, int total) {
  if ((threadIdx.x & 31) == 0) {
    store_relaxed(&state[tile], (tile == 0 ? FLAG_INCLUSIVE : FLAG_AGGREGATE)
                                    | static_cast<unsigned>(total));
  }
}

// One warp, all 32 lanes, after publish_total.  Looks back over windows
// of 32 predecessors, one load per lane, until a window holds an
// INCLUSIVE value: the tile's exclusive prefix is that value plus the
// aggregates above it.  Publishes (INCLUSIVE, prefix + total) and returns
// the prefix in every lane.  Tiles come from a ticket counter, so every
// predecessor's block has started and publishes its aggregate without
// waiting on anyone: no tile waits on a chain.
__device__ __forceinline__ int lookback_prefix(unsigned long long* state,
                                               int tile, int total) {
  const int lane = threadIdx.x & 31;
  unsigned prefix = 0;
  for (int end = tile; end > 0; end -= 32) {
    // Lane 31 reads the nearest predecessor; lanes before tile 0 read an
    // INCLUSIVE 0.
    const int t = end - 32 + lane;
    unsigned long long v;
    do {
      v = t >= 0 ? load_relaxed(&state[t]) : FLAG_INCLUSIVE;
    } while (__any_sync(0xffffffffu, (v >> 32) == 0));
    const unsigned incl = __ballot_sync(0xffffffffu, (v >> 32) == 2);
    const int from = incl ? 31 - __clz(incl) : 0;
    unsigned sum = lane >= from ? static_cast<unsigned>(v) : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    }
    prefix += sum;
    if (incl) break;
  }
  if (lane == 0 && tile > 0) {
    store_relaxed(&state[tile], FLAG_INCLUSIVE | (prefix + total));
  }
  return static_cast<int>(prefix);
}

// ---------------------------------------------------------------------------
// The kernels.

// count_kernel<Flat> replaces fused_transcode.py::_count_kernel and
// count_kernel<Packed> replaces ragged_transcode.py::_rcount_kernel: per
// 1024-element tile (total, err_flag, first_error), the triples that
// write_kernel's base offsets and the ragged per-document reduce read.
// Bytes bound: the input read once plus 12 bytes per tile written (and 12
// bytes of ownership per tile when packed).
//
// One warp per tile, CTILES tiles a block.  Lane l holds elements
// [32 l, 32 l + 32) of its tile in registers, in its narrow type packed
// into 32-bit words, loaded with 16-byte vector loads where the buffer
// starts on a 16-byte boundary and the lane's elements all lie below the
// tile's limit (element by element otherwise).  A lane takes the Reach<S>
// elements on either side from its neighbours' words by shuffles; lane 0
// and lane 31 read the previous and next tile's halo, masked by the
// geometry's limits (Flat, Packed).  Lanes widen to int32 in registers only, so the lane bodies
// are eval_lane's, with the reference's int32 semantics; the nibble tables
// are a shared-memory copy.  Nothing is staged in shared memory, so there
// are no bank conflicts and no block barrier after the tables.
//
// Each tile takes one of three classes (tile_class, which write_kernel
// shares), decided for the whole warp from its words and the Reach<S>
// elements before the tile (the reference's per-tile dispatch,
// src/repro/kernels/stages/driver.py): ASCII (every
// element and the inflow in [0, 0x80): each live lane is one unit and no
// error, ascii_tile_pred), the <=2-byte class (class2_pred: UTF-8 below
// 0xE0 with the inflow, UTF-16 below 0x800, UTF-32 in [0, 0x7FF]; none for
// Latin-1: decode2 and analyze2, with the Keiser-Lemire check still run
// under validate, since stray continuations and C0/C1 overlongs are
// errors in this class) and the general body.  Each class is lanewise
// equal to the general body on the tiles it admits, so the triples are
// those of the general body.  The bodies are instantiated per errors=
// policy and validate flag, and evaluate CROUND lanes per unrolled round.
constexpr int CTILES = THREADS / 32;     // tiles a block (at most)
constexpr int CITEMS = TILE / 32;        // consecutive elements per lane
constexpr int CROUND = 8;                // lanes per unrolled round

// A lane's elements of format S packed into 32-bit words.
template <int S>
struct Words {
  using T = typename Storage<S>::T;
  static constexpr int PER = 4 / static_cast<int>(sizeof(T));
  static constexpr int N = CITEMS / PER;         // words per lane
  static constexpr int ROUND = CROUND / PER;     // words per round
  static constexpr int BITS = 8 * static_cast<int>(sizeof(T));
  // Element k of word w, widened to int32 (zero-extended, as the
  // reference widens its unsigned storage).
  static __device__ __forceinline__ int32_t get(uint32_t w, int k) {
    if constexpr (PER == 1) {
      return static_cast<int32_t>(w);
    } else {
      return static_cast<int32_t>((w >> (BITS * k)) & ((1u << BITS) - 1));
    }
  }
  // Every element of w in the ASCII class: [0, 0x80).
  static __device__ __forceinline__ bool ascii(uint32_t w) {
    return (w & (PER == 4 ? 0x80808080u : PER == 2 ? 0xFF80FF80u
                                                    : 0xFFFFFF80u)) == 0;
  }
  // Every element of w in the <=2-byte class.
  static __device__ __forceinline__ bool class2(uint32_t w) {
    if constexpr (S == UTF8) {
      return (w & (w << 1) & (w << 2) & 0x80808080u) == 0;  // no byte >= E0
    } else if constexpr (S == UTF16) {
      return (w & 0xF800F800u) == 0;
    } else if constexpr (S == UTF32) {
      return (w & 0xFFFFF800u) == 0;
    } else {
      return false;
    }
  }
};

// The lane's CITEMS elements from `start`, those below `lim` elements on
// (0 past it), packed into words.
template <int S>
__device__ __forceinline__ void load_words(
    const typename Storage<S>::T* __restrict__ x, long long start,
    long long lim, bool vec, uint32_t (&w)[Words<S>::N]) {
  using W = Words<S>;
  if (vec && lim >= CITEMS) {
    const uint4* p = reinterpret_cast<const uint4*>(x + start);
#pragma unroll
    for (int i = 0; i < W::N / 4; ++i) {
      const uint4 v = p[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < W::N; ++i) {
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < W::PER; ++k) {
      const int e = i * W::PER + k;
      if (e < lim) acc |= static_cast<uint32_t>(x[start + e]) << (W::BITS * k);
    }
    w[i] = acc;
  }
}

// Reach<S> halo elements from `first`, at word positions pos0 on; those
// outside [0, lim) read 0.
template <int S>
__device__ __forceinline__ uint32_t halo_word(
    const typename Storage<S>::T* __restrict__ x, long long first, int pos0,
    long long lim) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < Reach<S>::value; ++k) {
    const long long j = first + k;
    if (j >= 0 && j < lim) {
      acc |= static_cast<uint32_t>(x[j]) << (Words<S>::BITS * (pos0 + k));
    }
  }
  return acc;
}

// Lane `lane` of the warp that owns tile `tile`: its CITEMS elements in w,
// loaded as load_words loads them below the tile's own limit, and the
// Reach<S> elements on either side, in the last positions of pw and the
// first of nw, taken from the neighbour lanes' words by shuffles; lane 0
// and lane 31 read the previous and next tile's halo, masked by the
// geometry's limits.  Every lane of the warp calls it.
template <int S, class G>
__device__ __forceinline__ void load_lane(
    const typename Storage<S>::T* __restrict__ x, const G& geo, int tile,
    int lane, uint32_t (&w)[Words<S>::N], uint32_t& pw, uint32_t& nw) {
  using W = Words<S>;
  constexpr int H = Reach<S>::value;
  const long long t0 = static_cast<long long>(tile) * TILE;
  const long long start = t0 + lane * CITEMS;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  load_words<S>(x, start, geo.own_limit(tile) - start, vec, w);
  pw = 0;
  nw = 0;
  if constexpr (H > 0) {
    pw = __shfl_up_sync(0xffffffffu, w[W::N - 1], 1);
    nw = __shfl_down_sync(0xffffffffu, w[0], 1);
    if (lane == 0) pw = halo_word<S>(x, t0 - H, W::PER - H, geo.prev_limit(tile));
    if (lane == 31) nw = halo_word<S>(x, t0 + TILE, 0, geo.next_limit(tile));
  }
}

// The classes of the reference's per-tile dispatch
// (src/repro/kernels/stages/driver.py::onepass_tile).
enum TileClass { CLASS_ASCII = 0, CLASS_2 = 1, CLASS_GENERAL = 2 };

// The tile's class, the one decision count_kernel and write_kernel both
// dispatch on, made for the whole warp (every lane calls it) from the
// lanes' words and the Reach<S> elements before the tile (lane 0's pw; the
// other lanes' pw repeat their neighbours' elements): ASCII when every
// element and the inflow lie in [0, 0x80) (ascii_tile_pred), the <=2-byte
// class when they pass class2_pred (UTF-8 below 0xE0 with the inflow,
// UTF-16 below 0x800, UTF-32 in [0, 0x7FF]; never for Latin-1), else
// general.  With ascii 0 (the entry points' ascii_fastpath=False) no tile
// is ASCII: an all-ASCII tile takes the <=2-byte or the general body.
template <int S>
__device__ __forceinline__ int tile_class(const uint32_t (&w)[Words<S>::N],
                                          uint32_t pw, int ascii_ok) {
  using W = Words<S>;
  constexpr int H = Reach<S>::value;
  bool ascii = true, c2 = true;
#pragma unroll
  for (int i = 0; i < W::N; ++i) {
    ascii = ascii && W::ascii(w[i]);
    c2 = c2 && W::class2(w[i]);
  }
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const int32_t v = W::get(pw, W::PER - H + k);
    ascii = ascii && v >= 0 && v < 0x80;
    if (S == UTF8) c2 = c2 && v >= 0 && v < 0xE0;
  }
  if (ascii_ok && __all_sync(0xffffffffu, ascii)) return CLASS_ASCII;
  return __all_sync(0xffffffffu, c2) ? CLASS_2 : CLASS_GENERAL;
}

// One lane's CITEMS elements through the lane body of class C2 (the
// <=2-byte class or the general one): its units, error flag and first
// located error.  pw holds the Reach<S> elements before the lane in its
// last positions, nw those after it in its first.  With KEEP the lane
// also keeps each element's code point in cps (-1 where it emits no
// unit), for the one-pass kernels' stores: the round's code points enter
// at the top of cps and the earlier ones move down, so every index stays
// a constant and cps stays in registers.
template <int S, int D, bool C2, bool REPLACE, bool VALIDATE, bool KEEP>
__device__ __forceinline__ void count_body(
    uint32_t pw, const uint32_t (&w0)[Words<S>::N], uint32_t nw, int g0,
    int end, const int32_t* tab, int& tot, int& err, int& ferr,
    int32_t (&cps)[CITEMS]) {
  using W = Words<S>;
  constexpr int H = Reach<S>::value;
  uint32_t w[W::N + 1];
#pragma unroll
  for (int i = 0; i < W::N; ++i) w[i] = w0[i];
  w[W::N] = nw;
  uint32_t prev = pw;
#pragma unroll 1
  for (int r = 0; r < CITEMS / CROUND; ++r) {
    int32_t e[CROUND + 2 * H];
#pragma unroll
    for (int k = 0; k < H; ++k) e[k] = W::get(prev, W::PER - H + k);
#pragma unroll
    for (int j = 0; j < CROUND; ++j) e[H + j] = W::get(w[j / W::PER], j % W::PER);
#pragma unroll
    for (int k = 0; k < H; ++k) e[H + CROUND + k] = W::get(w[W::ROUND], k);
    int32_t got[CROUND];
#pragma unroll
    for (int j = 0; j < CROUND; ++j) {
      const int g = g0 + r * CROUND + j;
      const Lane l = eval_lane<S, D, C2>(e + H + j, g < end, REPLACE,
                                         VALIDATE, tab);
      tot += l.units;
      err |= l.err;
      if (l.sub) ferr = min(ferr, g);
      got[j] = l.units ? l.cp : -1;
    }
    if constexpr (KEEP) {
#pragma unroll
      for (int i = 0; i + CROUND < CITEMS; ++i) cps[i] = cps[i + CROUND];
#pragma unroll
      for (int j = 0; j < CROUND; ++j) cps[CITEMS - CROUND + j] = got[j];
    }
    prev = w[W::ROUND - 1];
#pragma unroll
    for (int i = 0; i + W::ROUND <= W::N; ++i) w[i] = w[i + W::ROUND];
  }
}

template <int S, int D, bool C2, bool KEEP>
__device__ __forceinline__ void count_lane(
    uint32_t pw, const uint32_t (&w)[Words<S>::N], uint32_t nw, int g0,
    int end, bool replace, bool validate, const int32_t* tab, int& tot,
    int& err, int& ferr, int32_t (&cps)[CITEMS]) {
  if (replace) {
    if (validate) {
      count_body<S, D, C2, true, true, KEEP>(pw, w, nw, g0, end, tab, tot,
                                             err, ferr, cps);
    } else {
      count_body<S, D, C2, true, false, KEEP>(pw, w, nw, g0, end, tab, tot,
                                              err, ferr, cps);
    }
  } else if (validate) {
    count_body<S, D, C2, false, true, KEEP>(pw, w, nw, g0, end, tab, tot,
                                            err, ferr, cps);
  } else {
    count_body<S, D, C2, false, false, KEEP>(pw, w, nw, g0, end, tab, tot,
                                             err, ferr, cps);
  }
}

template <int S, int D, class G>
__global__ void __launch_bounds__(THREADS)
count_kernel(const typename Storage<S>::T* __restrict__ x, G geo, int nblk,
             int replace, int validate, int ascii, int* __restrict__ tot_out,
             int* __restrict__ err_out, int* __restrict__ ferr_out) {
  using W = Words<S>;
  __shared__ int32_t tab[KL_ENTRIES];
  if constexpr (S == UTF8) {
    load_kl_tables(tab);
    __syncthreads();
  }
  const int tile = blockIdx.x * CTILES + (threadIdx.x >> 5);
  if (tile >= nblk) return;
  const int lane = threadIdx.x & 31;
  uint32_t w[W::N], pw, nw;
  load_lane<S>(x, geo, tile, lane, w, pw, nw);
  const int cls = tile_class<S>(w, pw, ascii);

  const int end = geo.end(tile);
  const int g0 = tile * TILE + lane * CITEMS;
  int tot = 0, err = 0, ferr = IMAX;
  int32_t unused[CITEMS];
  if (cls == CLASS_ASCII) {
    tot = max(0, min(CITEMS, end - g0));
  } else if (cls == CLASS_2) {
    if constexpr (S != LATIN1) {
      count_lane<S, D, true, false>(pw, w, nw, g0, end, replace, validate,
                                    tab, tot, err, ferr, unused);
    }
  } else {
    count_lane<S, D, false, false>(pw, w, nw, g0, end, replace, validate,
                                   tab, tot, err, ferr, unused);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    tot += __shfl_xor_sync(0xffffffffu, tot, o);
    err |= __shfl_xor_sync(0xffffffffu, err, o);
    ferr = min(ferr, __shfl_xor_sync(0xffffffffu, ferr, o));
  }
  if (lane == 0) {
    tot_out[tile] = tot;
    err_out[tile] = err;
    ferr_out[tile] = ferr;
  }
}

// write_kernel<Flat> replaces fused_transcode.py::_write_kernel and
// write_kernel<Packed> replaces ragged_transcode.py::_rwrite_kernel: each
// tile's destination units, stored at base[tile] + in-tile rank, only
// below cap, without validation.  Bytes bound: the input read once plus
// the cap-unit output written once (and 4 bytes of base, 12 of ownership
// when packed, per tile).
//
// One warp per tile, CTILES tiles a block, the tile in registers as
// count_kernel holds it (load_lane), dispatched on the same class
// (tile_class):
//   ASCII     a widening copy: the live elements are a prefix of the tile
//             and each is its own unit, at rank g - t0;
//   <=2-byte  eval_lane<S, D, true> (the reference's decode_once2 /
//             stage_decoded2), at most max_units2 units a lane;
//   general   eval_lane<S, D, false>.
// A lane keeps its 32 code points in registers (-1 at dead lanes), ranks
// its total with one warp exclusive scan, and writes its units in the
// narrow destination type into the warp's region of shared memory,
// compacted.  After __syncwarp the warp copies the region to out with
// 16-byte stores where the destination is aligned (the region is offset
// so that its units share the destination's alignment mod 16), element by
// element for the head and the tail: consecutive lanes of a store write
// consecutive addresses.
//
// The kernel writes every element of out[0, cap) once, so the wrapper
// allocates it uninitialised.  That needs base to be the exclusive scan
// of this pass's tile totals (the count pass's, which every caller
// passes): the tiles' units then cover [0, end), end = base[nblk - 1] +
// the last tile's total.  The last tile's warp writes zeros from end to
// the end of its window, base[nblk - 1] + TILE * max_units, and every
// block zero-fills its grid-stride share of the rest of [0, cap).
constexpr int STAGE_BYTES = 4 * TILE + 16;  // a warp's region: the widest
                                            // window and the alignment pad

// Destination units of one lane at most (the reference's stage_units:
// the destination's length of the source's largest speculative code
// point), and in the <=2-byte class (stage_units2: every code point of
// the class fits 11 bits, and a UTF-8 source's analysis may substitute
// U+FFFD).  TILE * units * sizeof(unit) <= 4 * TILE in every cell.
template <int S, int D>
__host__ __device__ constexpr int max_units() {
  return D == UTF8 ? (S == LATIN1 ? 2 : 4)
       : D == UTF16 ? (S == LATIN1 ? 1 : 2) : 1;
}

template <int S, int D>
__host__ __device__ constexpr int max_units2() {
  return D == UTF8 ? (S == UTF8 ? 3 : 2) : 1;
}

// Element k of a lane, k in [-Reach<S>, CITEMS + Reach<S>): from pw
// before the lane, w inside it, nw after it.  k is a constant wherever the
// loops that call it are unrolled.
template <int S>
__device__ __forceinline__ int32_t lane_element(
    uint32_t pw, const uint32_t (&w)[Words<S>::N], uint32_t nw, int k) {
  using W = Words<S>;
  if (k < 0) return W::get(pw, W::PER + k);
  if (k >= CITEMS) return W::get(nw, k - CITEMS);
  return W::get(w[k / W::PER], k % W::PER);
}

// The lane's rank among the warp's unit totals (exclusive scan of mine);
// total receives the warp's sum in every lane.
__device__ __forceinline__ int warp_rank(int mine, int lane, int& total) {
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  total = __shfl_sync(0xffffffffu, incl, 31);
  return incl - mine;
}

// Write the units of a lane's CITEMS code points (-1 where it emits none)
// in the narrow destination type to st from pos on, compacted; at most U
// units a code point (max_units2 in the <=2-byte class, else max_units).
template <int S, int D, bool C2>
__device__ __forceinline__ void stage_lane(const int32_t (&cps)[CITEMS],
                                           int pos,
                                           typename Storage<D>::T* st) {
  using T = typename Storage<D>::T;
  constexpr int U = C2 ? max_units2<S, D>() : max_units<S, D>();
#pragma unroll
  for (int i = 0; i < CITEMS; ++i) {
    const int32_t cp = cps[i];
    const int u = cp < 0 ? 0 : unit_len<D>(cp);
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (j < u) st[pos + j] = static_cast<T>(encode_unit<D>(cp, j));
    }
    pos += u;
  }
}

// One lane of a <=2-byte (C2) or general tile: evaluates its CITEMS
// elements, ranks its unit total across the warp, and writes its units,
// compacted, to st from the lane's rank on.  Returns the tile's total.
template <int S, int D, bool C2, bool REPLACE>
__device__ __forceinline__ int write_lane(
    uint32_t pw, const uint32_t (&w)[Words<S>::N], uint32_t nw, int g0,
    int end, int lane, typename Storage<D>::T* st) {
  constexpr int H = Reach<S>::value;
  int32_t cps[CITEMS];
  int mine = 0;
#pragma unroll
  for (int i = 0; i < CITEMS; ++i) {
    int32_t e[2 * H + 1];
#pragma unroll
    for (int k = 0; k <= 2 * H; ++k) e[k] = lane_element<S>(pw, w, nw, i - H + k);
    const Lane l = eval_lane<S, D, C2>(e + H, g0 + i < end, REPLACE, false,
                                       nullptr);
    cps[i] = l.units ? l.cp : -1;
    mine += l.units;
  }
  int total;
  stage_lane<S, D, C2>(cps, warp_rank(mine, lane, total), st);
  return total;
}

template <int S, int D, bool C2>
__device__ __forceinline__ int write_lane(
    uint32_t pw, const uint32_t (&w)[Words<S>::N], uint32_t nw, int g0,
    int end, int lane, bool replace, typename Storage<D>::T* st) {
  return replace ? write_lane<S, D, C2, true>(pw, w, nw, g0, end, lane, st)
                 : write_lane<S, D, C2, false>(pw, w, nw, g0, end, lane, st);
}

// Copy units [0, len) of a warp's region to out[at, at + len), only below
// cap.  Unit i sits at st[i], and st shares out + at's alignment mod 16.
template <typename T>
__device__ __forceinline__ void copy_out(const T* st, T* __restrict__ out,
                                         long long at, long long len,
                                         long long cap, int lane) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const long long hi = min(at + len, cap);
  if (hi <= at) return;
  const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(out + at) & 15);
  const long long a = min(hi, at + ((16 - skew) & 15) / static_cast<int>(sizeof(T)));
  const long long chunks = (hi - a) / V;
  const long long b = a + chunks * V;
  if (lane < a - at) out[at + lane] = st[lane];
  if (lane < hi - b) out[b + lane] = st[b - at + lane];
  const uint4* src = reinterpret_cast<const uint4*>(st + (a - at));
  uint4* dst = reinterpret_cast<uint4*>(out + a);
  for (long long c = lane; c < chunks; c += 32) dst[c] = src[c];
}

// Bytes [d, d + 16) of the 32 bytes p then q (0 <= d < 16): funnel
// shifts of neighbouring words.  d is the same in every lane of the warp.
__device__ __forceinline__ uint4 bytes_at(uint4 p, uint4 q, int d) {
  const int r = 8 * (d & 3);
  switch (d >> 2) {
    case 0:
      return make_uint4(__funnelshift_r(p.x, p.y, r), __funnelshift_r(p.y, p.z, r),
                        __funnelshift_r(p.z, p.w, r), __funnelshift_r(p.w, q.x, r));
    case 1:
      return make_uint4(__funnelshift_r(p.y, p.z, r), __funnelshift_r(p.z, p.w, r),
                        __funnelshift_r(p.w, q.x, r), __funnelshift_r(q.x, q.y, r));
    case 2:
      return make_uint4(__funnelshift_r(p.z, p.w, r), __funnelshift_r(p.w, q.x, r),
                        __funnelshift_r(q.x, q.y, r), __funnelshift_r(q.y, q.z, r));
    default:
      return make_uint4(__funnelshift_r(p.w, q.x, r), __funnelshift_r(q.x, q.y, r),
                        __funnelshift_r(q.y, q.z, r), __funnelshift_r(q.z, q.w, r));
  }
}

// copy_out for units staged before their offset was known: unit i sits at
// st[i], st on a 16-byte boundary.  Element stores for the head before
// out + at's first 16-byte boundary and for the tail; each 16-byte store
// between takes its bytes from the two 16-byte chunks of st it straddles
// (bytes_at).  Reads at most 16 bytes past the units.
template <typename T>
__device__ __forceinline__ void copy_out_shifted(const T* st,
                                                 T* __restrict__ out,
                                                 long long at, long long len,
                                                 long long cap, int lane) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const long long hi = min(at + len, cap);
  if (hi <= at) return;
  const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(out + at) & 15);
  const int head = ((16 - skew) & 15) / static_cast<int>(sizeof(T));
  const long long a = min(hi, at + head);
  const long long chunks = (hi - a) / V;
  const long long b = a + chunks * V;
  if (lane < a - at) out[at + lane] = st[lane];
  if (lane < hi - b) out[b + lane] = st[b - at + lane];
  const int d = head * static_cast<int>(sizeof(T));
  const uint4* src = reinterpret_cast<const uint4*>(st);
  uint4* dst = reinterpret_cast<uint4*>(out + a);
  for (long long c = lane; c < chunks; c += 32) {
    dst[c] = bytes_at(src[c], src[c + 1], d);
  }
}

// The block's grid-stride share of out[lo, cap) set to 0: 16-byte stores
// from the first aligned element on, element stores before it and after
// the last whole chunk.
template <typename T>
__device__ __forceinline__ void zero_fill(T* __restrict__ out, long long lo,
                                          long long cap) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if (lo >= cap) return;
  const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(out + lo) & 15);
  const long long a = min(cap, lo + ((16 - skew) & 15) / static_cast<int>(sizeof(T)));
  const long long chunks = (cap - a) / V;
  const long long b = a + chunks * V;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  if (tid < a - lo) out[lo + tid] = 0;
  if (tid < cap - b) out[b + tid] = 0;
  uint4* dst = reinterpret_cast<uint4*>(out + a);
  for (long long c = tid; c < chunks; c += stride) dst[c] = make_uint4(0, 0, 0, 0);
}

// Three blocks an SM (at most 80 registers a thread, no spills): a warp
// waits on its tile's loads, and more warps hide that wait better than
// the registers a freer allocation would save.
template <int S, int D, class G>
__global__ void __launch_bounds__(THREADS, 3)
write_kernel(const typename Storage<S>::T* __restrict__ x, G geo, int nblk,
             int replace, int ascii, const int* __restrict__ base, int cap,
             typename Storage<D>::T* __restrict__ out) {
  using T = typename Storage<D>::T;
  using W = Words<S>;
  constexpr int U = max_units<S, D>();
  __shared__ __align__(16) unsigned char stage[CTILES][STAGE_BYTES];
  zero_fill(out, static_cast<long long>(base[nblk - 1]) + TILE * U, cap);
  const int tile = blockIdx.x * CTILES + (threadIdx.x >> 5);
  if (tile >= nblk) return;
  const int lane = threadIdx.x & 31;
  uint32_t w[W::N], pw, nw;
  load_lane<S>(x, geo, tile, lane, w, pw, nw);
  const int cls = tile_class<S>(w, pw, ascii);

  const long long t0 = static_cast<long long>(tile) * TILE;
  const long long at = base[tile];
  const int end = geo.end(tile);
  const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(out + at) & 15);
  T* st = reinterpret_cast<T*>(stage[threadIdx.x >> 5] + skew);
  int total;
  if (cls == CLASS_ASCII) {
    // Rank g - t0: lane l writes elements l, l + 32, ...  The tile is
    // re-read from global memory (the cache lines this warp just loaded)
    // so that consecutive lanes write consecutive units.
    total = static_cast<int>(max(0LL, min(static_cast<long long>(TILE),
                                          end - t0)));
    const long long lim = geo.own_limit(tile);
#pragma unroll 4
    for (int i = lane; i < TILE; i += 32) {
      st[i] = t0 + i < lim ? static_cast<T>(x[t0 + i]) : T(0);
    }
  } else if (cls == CLASS_2) {
    if constexpr (S != LATIN1) {
      total = write_lane<S, D, true>(pw, w, nw, tile * TILE + lane * CITEMS,
                                     end, lane, replace, st);
    } else {
      total = 0;
    }
  } else {
    total = write_lane<S, D, false>(pw, w, nw, tile * TILE + lane * CITEMS,
                                    end, lane, replace, st);
  }
  long long len = total;
  if (tile == nblk - 1) {
    // The last tile's window ends in zeros; zero_fill writes past it.
    __syncwarp();
    for (int i = total + lane; i < TILE * U; i += 32) st[i] = T(0);
    len = TILE * U;
  }
  __syncwarp();
  copy_out(st, out, at, len, cap, lane);
}

// onepass_kernel<Flat> replaces onepass_transcode.py::_onepass_kernel
// and onepass_kernel<Packed> replaces ragged_transcode.py::_ronepass_kernel:
// count and write off one evaluation of each tile.  Bytes bound: the
// input read once plus the cap-unit output written once (and 24 bytes of
// ownership and per-tile scalars per tile when packed); no intermediate
// leaves the chip.
//
// One warp per tile, the tile in registers (load_lane), dispatched on its
// class (tile_class) as the count and write kernels are:
//   ASCII     total = the live lanes, no error; the units are the
//             elements, each lane keeping units l, l + 32, ... in registers
//             (read again from the cache lines load_lane brought in);
//   <=2-byte  count_body<S, D, true> with the Keiser-Lemire check under
//             validate, as count_kernel runs it, so the per-tile (err,
//             first_error) are the general body's;
//   general   count_body<S, D, false>.
// Each lane evaluates its CITEMS elements once, folding its units, error
// flag and first located error, and keeps their code points in registers
// (count_body's KEEP).  One warp scan ranks the lanes' totals.
//
// The TPU kernel's SMEM carry becomes a decoupled look-back
// (lookback_prefix), one per warp-tile: a block takes one ticket, and its
// warp w owns tile ticket * CTILES + w; warps past nblk leave
// before publishing.  A warp publishes its total as soon as it has it, so
// no tile waits on a chain of predecessors, and every tile below a ticket
// holder's tiles belongs to a block that has started (or to the holder's
// own earlier warps), whose aggregates are published without waiting: no
// deadlock.  While its predecessors publish, the warp writes its units,
// narrowed, compacted, into its region of shared memory; once it has its
// prefix, copy_out_shifted stores them at prefix with 16-byte stores
// (realigned to out + prefix on the way), only below cap.
//
// Flat: ctl = [ticket, err, IMAX - first error, unused], which the
// wrapper zero-fills with state.  Each tile's lane 0 folds its err and
// first error into ctl (atomicMax on both, so 0 is the empty fold); tile
// nblk - 1 writes fin[0] = its prefix + total, the count, and
// onepass_tail_kernel, once every tile's fold has landed, fin[1], the
// status.
//
// Packed: ctl = [ticket]; each tile writes its (total, err, first_error),
// which the wrapper reduces per document; the look-back carries only the
// offset (the per-document segment scan, documents being packed in order,
// densely), and the per-tile scalars need no ordering across blocks.
//
// CTILES tiles a block, as count and write take: fewer tiles a block on
// small inputs, to spread their warps over more SMs, measured the same
// within 4 % at 256 KiB (PERF.md).  out[end, cap) is left to
// onepass_tail_kernel, launched behind it.
//
// On the card its time is count_kernel's lane body plus the staging of
// the kept code points (80 registers a thread: 3 blocks an SM) plus the
// look-back's wait for its predecessors' totals; it is issue-bound, as
// count and write are, far above the bytes bound (PERF.md).
template <int S, int D, class G>
__global__ void __launch_bounds__(THREADS)
onepass_kernel(const typename Storage<S>::T* __restrict__ x, G geo, int nblk,
               int replace, int validate, int ascii, int cap,
               unsigned long long* __restrict__ state, int* __restrict__ ctl,
               int* __restrict__ fin, int* __restrict__ tot_out,
               int* __restrict__ err_out, int* __restrict__ ferr_out,
               typename Storage<D>::T* __restrict__ out) {
  using T = typename Storage<D>::T;
  using W = Words<S>;
  __shared__ __align__(16) unsigned char stage[CTILES][STAGE_BYTES];
  __shared__ int32_t tab[KL_ENTRIES];
  __shared__ int s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(&ctl[0], 1);
  if constexpr (S == UTF8) load_kl_tables(tab);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = s_ticket * CTILES + warp;
  if (tile >= nblk) return;
  uint32_t w[W::N], pw, nw;
  load_lane<S>(x, geo, tile, lane, w, pw, nw);
  const int cls = tile_class<S>(w, pw, ascii);

  const long long t0 = static_cast<long long>(tile) * TILE;
  const int end = geo.end(tile);
  const int g0 = tile * TILE + lane * CITEMS;
  int32_t cps[CITEMS];
  int total, rank = 0, err = 0, ferr = IMAX;
  if (cls == CLASS_ASCII) {
    // The units are the elements: lane l keeps units l, l + 32, ... in
    // cps, read again from the cache lines load_lane just brought in.
    total = static_cast<int>(max(0LL, min(static_cast<long long>(TILE),
                                          end - t0)));
    const long long lim = geo.own_limit(tile);
#pragma unroll
    for (int j = 0; j < CITEMS; ++j) {
      const long long i = t0 + lane + 32 * j;
      cps[j] = i < lim ? static_cast<int32_t>(x[i]) : 0;
    }
  } else {
    int mine = 0;
    if (cls == CLASS_2) {
      if constexpr (S != LATIN1) {
        count_lane<S, D, true, true>(pw, w, nw, g0, end, replace, validate,
                                     tab, mine, err, ferr, cps);
      }
    } else {
      count_lane<S, D, false, true>(pw, w, nw, g0, end, replace, validate,
                                    tab, mine, err, ferr, cps);
    }
    rank = warp_rank(mine, lane, total);
    err = static_cast<int>(__reduce_or_sync(0xffffffffu,
                                            static_cast<unsigned>(err)));
    ferr = __reduce_min_sync(0xffffffffu, ferr);
  }
  publish_total(state, tile, total);
  if (lane == 0) {
    if constexpr (G::packed) {
      tot_out[tile] = total;
      err_out[tile] = err;
      ferr_out[tile] = ferr;
    } else {
      if (err) atomicMax(&ctl[1], err);
      if (ferr != IMAX) atomicMax(&ctl[2], IMAX - ferr);
    }
  }

  // The units, staged while the predecessors publish.
  T* st = reinterpret_cast<T*>(stage[warp]);
  if (cls == CLASS_ASCII) {
#pragma unroll
    for (int j = 0; j < CITEMS; ++j) {
      if (lane + 32 * j < total) st[lane + 32 * j] = static_cast<T>(cps[j]);
    }
  } else if (cls == CLASS_2) {
    if constexpr (S != LATIN1) stage_lane<S, D, true>(cps, rank, st);
  } else {
    stage_lane<S, D, false>(cps, rank, st);
  }
  __syncwarp();
  const int prefix = lookback_prefix(state, tile, total);
  if constexpr (!G::packed) {
    if (lane == 0 && tile == nblk - 1) fin[0] = prefix + total;
  }
  copy_out_shifted(st, out, prefix, total, cap, lane);
}

// The tail of a one-pass launch, behind onepass_kernel on the same stream:
// out[*end, cap) set to 0, where *end is the one-pass count (fin[0]) or,
// for the packed kernel, the last tile's INCLUSIVE value (the low word of
// state[nblk - 1]); for one buffer (ctl not null) also fin[1], the status
// of the error fold.  Only the last tile knows the end, and no block of
// the one-pass kernel may wait for it (a resident block spinning for the
// last ticket could starve the block that would take it), so the zeros
// come from this grid-stride launch, which reads the end on the device
// once every tile has finished: no host sync.  Bytes bound: the zeros,
// written once.
template <typename T>
__global__ void __launch_bounds__(THREADS)
onepass_tail_kernel(const int* __restrict__ end, const int* __restrict__ ctl,
                    int* __restrict__ fin, int cap, T* __restrict__ out) {
  if (ctl != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    fin[1] = status_from_first(IMAX - ctl[2], ctl[1]);
  }
  zero_fill(out, static_cast<long long>(*end), static_cast<long long>(cap));
}

// ---------------------------------------------------------------------------
// The legacy kernels (kernels/ops.py).  What bounds them is the bytes
// they move: the decode and encode kernels write 12 and 20 bytes of int32
// planes per input element, one block per 1024-element tile, thread t
// handling lanes t, t + 256, t + 512 and t + 768, so each store of a warp
// covers 32 consecutive int32 (128 bytes); the validation kernel reads the
// input and writes 4 bytes per tile, one warp per tile (below).

constexpr int LEGACY_ITEMS = TILE / THREADS;  // lanes per thread
constexpr int LEGACY_HALO = 3;                // the decode's reach

// Stage tile `tile` with HB elements of look-back and HA of look-ahead
// into shared memory as int32 lanes; elements at or past n, and before
// the stream, read 0 (the reference's _mask_padding and its zero boundary
// tiles).
template <typename T, int HB, int HA>
__device__ __forceinline__ void load_legacy(const T* __restrict__ x, int n,
                                            int tile, int32_t* s) {
  const long long start = static_cast<long long>(tile) * TILE - HB;
  for (int k = threadIdx.x; k < TILE + HB + HA; k += THREADS) {
    const long long j = start + k;
    s[k] = (j >= 0 && j < n) ? static_cast<int32_t>(x[j]) : 0;
  }
}

// Block-wide maximum; the result is valid in thread 0.
__device__ __forceinline__ int block_max(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) v = max(v, red[w]);
  }
  return v;
}

// jnp.take at its default mode on a 16-entry table: an index in [-16, 16)
// reads it (negative ones from the end), any other reads int32 min, so
// int32 input wider than a byte keeps the reference's result.
__device__ __forceinline__ int32_t table_take(const int32_t* table, int i) {
  return (i >= -16 && i < 16) ? table[i & 15] : INT32_MIN;
}

__device__ __forceinline__ int legacy_seq_len(int b) {
  return b < 0x80 ? 1 : b < 0xC0 ? 0 : b < 0xE0 ? 2
       : b < 0xF0 ? 3 : b < 0xF8 ? 4 : 0;
}

// validate_kernel replaces utf8_validate.py::utf8_validate_kernel: per
// 1024-element tile, the maximum over its elements of the Keiser-Lemire
// sc ^ must_be_cont, the previous tile's last three elements as look-back
// (0 before the stream and at or past n).  Bytes bound: the input read
// once and 4 bytes per tile written.
//
// One warp per tile, CTILES tiles a block, the tile in registers: a lane
// holds VLane<T>::CHUNKS chunks of 16 bytes (ELEMS elements each), loaded
// with 16-byte vector loads where the buffer starts on a 16-byte boundary
// and the chunk lies below n (element by element otherwise).  Chunk c of
// lane l starts at element (32 c + l) * ELEMS of the tile, so that each
// load instruction of the warp reads 512 consecutive bytes (count_kernel's
// layout, lane l holding elements [32 l, 32 l + 32), measured the same).
// A chunk's look-back is the last elements of the chunk before it in the
// stream, taken from the lane that holds it by a shuffle (vpred); lane 0
// reads the previous tile's.
//
// Each tile takes one of three classes, decided for the whole warp by
// __all_sync from its elements and the three before it:
//   ASCII     every element in [0, 0x80): the maximum is 0, since
//             byte_1_high[p1 >> 4] & byte_1_low[p1 & 15] &
//             byte_2_high[b >> 4] is 0 on every pair of ASCII bytes and
//             must_be_cont needs a byte >= 0xE0; no lookups.
//   <=2-byte  every element in [0, 0xE0): must_be_cont is 0, the maximum
//             is that of sc alone.
//   general   the full body.
// The bodies run on bytes packed four to a 32-bit word: the look-back
// bytes come from funnel shifts of a word and the one before it, and the
// three 16-entry tables sit in registers as four words each, read four
// bytes at a time with PRMT (lookup16).  byte_1_high & byte_1_low is
// looked up once per byte and serves as the next byte's look-back half
// through a funnel shift; byte_2_high shares byte_1_high's selector.  The
// lane keeps its bytewise maximum as two maxima of 16-bit lanes
// (__vmaxu2, one VIMNMX each on sm_90, where __vmaxu4 compiles to six
// instructions).  int32 input packs into bytes when every element of the
// tile lies in [0, 0xE0); any other int32 tile runs a scalar body with
// table_take's jnp.take semantics.  The warp's maximum comes from
// __reduce_max_sync and one store; blocks share nothing.
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct VLane {
  static constexpr int ELEMS = 16 / static_cast<int>(sizeof(T));
  static constexpr int CHUNKS = TILE / 32 / ELEMS;
  static constexpr int PER = 4 / static_cast<int>(sizeof(T));  // per word
};

// The three nibble tables as bytes, four entries a word: kKLB[4 t + k]
// holds entries 4k..4k+3 of table t (byte_1_high, byte_1_low,
// byte_2_high), set by transcode_set_tables with kKL.
__constant__ uint32_t kKLB[12];

// A 16-entry byte table read four bytes at a time.  PRMT picks each
// result byte from the eight bytes of two words by a 3-bit selector, so
// Sel holds the four indices' low three bits (entries 0-7 from t[0..1],
// 8-15 from t[2..3]) and a byte mask of their bit 3 that picks between
// the two reads.
struct Sel {
  uint32_t low3, upper;
};

// The selectors of the four bytes of v, each in [0, 16).
__device__ __forceinline__ Sel nibble_sel(uint32_t v) {
  const uint32_t s = __byte_perm(v | (v >> 4), 0, 0x4420);  // nibble k = byte k
  return {s & 0x7777u, __byte_perm(0u, FULL, (s >> 1) & 0x4444u)};
}

__device__ __forceinline__ uint32_t lookup16(const uint32_t* t, Sel s) {
  const uint32_t lo = __byte_perm(t[0], t[1], s.low3);
  const uint32_t hi = __byte_perm(t[2], t[3], s.low3);
  return (hi & s.upper) | (lo & ~s.upper);
}

// The lookups of the four bytes of w: f = byte_1_high[b >> 4] &
// byte_1_low[b & 15], the half of sc that depends on the previous byte
// (it becomes the next byte's), and g = byte_2_high[b >> 4], the half
// that depends on the byte itself.
__device__ __forceinline__ void kl_halves(uint32_t w, const uint32_t (&t)[12],
                                          uint32_t& f, uint32_t& g) {
  const Sel hi = nibble_sel((w >> 4) & 0x0F0F0F0Fu);
  f = lookup16(t, hi) & lookup16(t + 4, nibble_sel(w & 0x0F0F0F0Fu));
  g = lookup16(t + 8, hi);
}

// sc (and, when GENERAL, ^ must_be_cont) of the four bytes of w, bytewise:
// fprev and prev are f and the bytes of the word before w in the stream.
template <bool GENERAL>
__device__ __forceinline__ uint32_t kl4(uint32_t fprev, uint32_t f,
                                        uint32_t g, uint32_t prev,
                                        uint32_t w) {
  const uint32_t sc = __funnelshift_r(fprev, f, 24) & g;
  if constexpr (!GENERAL) {
    return sc;
  } else {
    const uint32_t p2 = __funnelshift_r(prev, w, 16);
    const uint32_t p3 = __funnelshift_r(prev, w, 8);
    const uint32_t must = ((p2 & (p2 << 1) & (p2 << 2)) |         // >= E0
                           (p3 & (p3 << 1) & (p3 << 2) & (p3 << 3))) &  // F0
                          0x80808080u;
    return sc ^ must;
  }
}

// The lane's chunks: r[c] holds chunk c's ELEMS elements, 0 at or past n.
template <typename T>
__device__ __forceinline__ void vload(const T* __restrict__ x, long long t0,
                                      int n, int lane, bool vec,
                                      uint4 (&r)[VLane<T>::CHUNKS]) {
  using L = VLane<T>;
#pragma unroll
  for (int c = 0; c < L::CHUNKS; ++c) {
    const long long start = t0 + (32 * c + lane) * L::ELEMS;
    const long long lim = n - start;
    if (vec && lim >= L::ELEMS) {
      r[c] = *reinterpret_cast<const uint4*>(x + start);
      continue;
    }
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < L::ELEMS; ++k) {
      if (k < lim) {
        w[k / L::PER] |= static_cast<uint32_t>(x[start + k])
                         << (8 * static_cast<int>(sizeof(T)) * (k % L::PER));
      }
    }
    r[c] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// pred[c]: the value `last` takes for the chunk before chunk c in the
// stream, held by lane - 1 (lane 31's chunk c - 1 for lane 0); `halo`
// for the tile's first.
template <int C>
__device__ __forceinline__ void vpred(const uint32_t (&last)[C],
                                      uint32_t halo, int lane,
                                      uint32_t (&pred)[C]) {
  uint32_t carry = halo;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const uint32_t s = __shfl_sync(FULL, last[c], (lane + 31) & 31);
    pred[c] = lane ? s : carry;
    carry = s;
  }
}

// The lane's maximum on a tile of bytes (packed four to a word; int32
// elements all in [0, 0xE0)).  halo holds the three elements before the
// tile in bytes 1..3.
template <typename T, bool GENERAL>
__device__ __forceinline__ int kl_tile_bytes(
    const uint4 (&r)[VLane<T>::CHUNKS], uint32_t halo, int lane) {
  using L = VLane<T>;
  constexpr int C = L::CHUNKS;
  constexpr int WPC = L::ELEMS / 4;   // packed words per chunk
  uint32_t t[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) t[i] = kKLB[i];
  uint32_t w[C][WPC], f[C][WPC], g[C][WPC];
  uint32_t lastw[C], lastf[C], predw[C], predf[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if constexpr (sizeof(T) == 1) {
      w[c][0] = r[c].x;
      w[c][1] = r[c].y;
      w[c][2] = r[c].z;
      w[c][3] = r[c].w;
    } else {
      w[c][0] = r[c].x | (r[c].y << 8) | (r[c].z << 16) | (r[c].w << 24);
    }
#pragma unroll
    for (int j = 0; j < WPC; ++j) kl_halves(w[c][j], t, f[c][j], g[c][j]);
    lastw[c] = w[c][WPC - 1];
    lastf[c] = f[c][WPC - 1];
  }
  uint32_t fhalo, ghalo;
  kl_halves(halo, t, fhalo, ghalo);
  vpred<C>(lastf, fhalo, lane, predf);
  if constexpr (GENERAL) vpred<C>(lastw, halo, lane, predw);
  uint32_t even = 0, odd = 0;   // bytewise maxima, by 16-bit lanes
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int j = 0; j < WPC; ++j) {
      const uint32_t fp = j ? f[c][j - 1] : predf[c];
      const uint32_t wp = GENERAL ? (j ? w[c][j - 1] : predw[c]) : 0;
      const uint32_t v = kl4<GENERAL>(fp, f[c][j], g[c][j], wp, w[c][j]);
      even = __vmaxu2(even, v & 0x00FF00FFu);
      odd = __vmaxu2(odd, v & 0xFF00FF00u);
    }
  }
  const uint32_t m = __vmaxu2(even << 8, odd);
  return static_cast<int>(max(m >> 24, (m >> 8) & 0xFF));
}

// sc ^ must_be_cont of one int32 element b after p3, p2, p1, with
// jnp.take's semantics for the table indices.
__device__ __forceinline__ int kl_value_i32(int p3, int p2, int p1, int b) {
  const int sc = table_take(kKL, p1 >> 4) & table_take(kKL + 16, p1 & 0xF) &
                 table_take(kKL + 32, b >> 4);
  return sc ^ ((p2 >= 0xE0 || p3 >= 0xF0) ? 0x80 : 0);
}

// The lane's maximum on an int32 tile of the general class: element by
// element, each chunk's look-back the last three elements of the chunk
// before it (h on the tile's first).
__device__ __forceinline__ int kl_tile_i32(
    const uint4 (&r)[VLane<int32_t>::CHUNKS], const int32_t (&h)[3],
    int lane) {
  constexpr int C = VLane<int32_t>::CHUNKS;
  uint32_t ly[C], lz[C], lw[C], py[C], pz[C], pw[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ly[c] = r[c].y;
    lz[c] = r[c].z;
    lw[c] = r[c].w;
  }
  vpred<C>(ly, h[0], lane, py);
  vpred<C>(lz, h[1], lane, pz);
  vpred<C>(lw, h[2], lane, pw);
  int v = INT32_MIN;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int e[7] = {static_cast<int>(py[c]), static_cast<int>(pz[c]),
                      static_cast<int>(pw[c]), static_cast<int>(r[c].x),
                      static_cast<int>(r[c].y), static_cast<int>(r[c].z),
                      static_cast<int>(r[c].w)};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v = max(v, kl_value_i32(e[k], e[k + 1], e[k + 2], e[k + 3]));
    }
  }
  return v;
}

// Tile `tile` for validate_kernel: the lane's chunks (vload) and, in
// lane 0, the three elements before the tile (0 before the stream and at
// or past n).
template <typename T>
__device__ __forceinline__ void vload_tile(const T* __restrict__ x, int tile,
                                           int n, int lane, bool vec,
                                           uint4 (&r)[VLane<T>::CHUNKS],
                                           int32_t (&h)[3]) {
  const long long t0 = static_cast<long long>(tile) * TILE;
  vload<T>(x, t0, n, lane, vec, r);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const long long j = t0 - 3 + k;
    h[k] = (lane == 0 && j >= 0 && j < n) ? static_cast<int32_t>(x[j]) : 0;
  }
}

// The tile's maximum, in every lane: its class, decided for the warp, and
// that class's body, reduced over the warp.
template <typename T>
__device__ __forceinline__ int validate_tile(
    const uint4 (&r)[VLane<T>::CHUNKS], const int32_t (&h)[3], int lane) {
  bool ascii = true, c2 = true;
#pragma unroll
  for (int c = 0; c < VLane<T>::CHUNKS; ++c) {
    const uint32_t w[4] = {r[c].x, r[c].y, r[c].z, r[c].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 1) {
        ascii = ascii && (w[i] & 0x80808080u) == 0;
        c2 = c2 && (w[i] & (w[i] << 1) & (w[i] << 2) & 0x80808080u) == 0;
      } else {
        ascii = ascii && w[i] < 0x80u;
        c2 = c2 && w[i] < 0xE0u;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ascii = ascii && static_cast<uint32_t>(h[k]) < 0x80u;
    c2 = c2 && static_cast<uint32_t>(h[k]) < 0xE0u;
  }
  int v = 0;
  if (!__all_sync(FULL, ascii)) {
    const uint32_t halo = (static_cast<uint32_t>(h[0]) << 8) |
                          (static_cast<uint32_t>(h[1]) << 16) |
                          (static_cast<uint32_t>(h[2]) << 24);
    if (__all_sync(FULL, c2)) {
      v = kl_tile_bytes<T, false>(r, halo, lane);
    } else if constexpr (sizeof(T) == 1) {
      v = kl_tile_bytes<T, true>(r, halo, lane);
    } else {
      v = kl_tile_i32(r, h, lane);
    }
  }
  return __reduce_max_sync(FULL, v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
validate_kernel(const T* __restrict__ x, int n, int nblk,
                int* __restrict__ errs) {
  const int tile = blockIdx.x * CTILES + (threadIdx.x >> 5);
  if (tile >= nblk) return;
  const int lane = threadIdx.x & 31;
  uint4 r[VLane<T>::CHUNKS];
  int32_t h[3];
  vload_tile<T>(x, tile, n, lane, (reinterpret_cast<uintptr_t>(x) & 15) == 0,
                r, h);
  const int v = validate_tile<T>(r, h, lane);
  if (lane == 0) errs[tile] = v;
}

// Replaces utf8_decode.py::utf8_decode_kernel: stages/utf8.py::decode_tile
// per lane.  Its error map is the structural check (an expected
// continuation that is not one, or a byte >= 0xF8) or the scalar range
// check at leads, not the maximal-subpart analysis of the transcode.
// planes holds cp, lead and units, len lanes each.
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ x, int n, int len,
              int* __restrict__ planes, int* __restrict__ errs) {
  __shared__ int32_t s[LEGACY_HALO + TILE + LEGACY_HALO];
  __shared__ int red[WARPS];
  const int tile = blockIdx.x;
  load_legacy<T, LEGACY_HALO, LEGACY_HALO>(x, n, tile, s);
  __syncthreads();
  int err = 0;
#pragma unroll
  for (int k = 0; k < LEGACY_ITEMS; ++k) {
    const int lane = k * THREADS + threadIdx.x;
    const int32_t* p = s + LEGACY_HALO + lane;
    const int b = p[0];
    const int sl = legacy_seq_len(b);
    const bool lead = sl > 0;
    const int32_t cp = !lead ? 0 : sl == 1 ? b
                     : utf8_assemble(sl, b, p[1], p[2], p[3]);
    const bool is_cont = (b & 0xC0) == 0x80;
    const bool exp_cont = legacy_seq_len(p[-1]) >= 2 ||
                          legacy_seq_len(p[-2]) >= 3 ||
                          legacy_seq_len(p[-3]) >= 4;
    const bool struct_err = exp_cont != is_cont || b >= 0xF8;
    const int min_cp = sl == 2 ? 0x80 : sl == 3 ? 0x800
                     : sl == 4 ? 0x10000 : 0;
    const bool range_err =
        lead && (cp < min_cp || (cp >= 0xD800 && cp < 0xE000) ||
                 cp > 0x10FFFF);
    err |= struct_err || range_err;
    const long long g = static_cast<long long>(tile) * TILE + lane;
    if (g < len) {
      planes[g] = cp;
      planes[len + g] = lead;
      planes[2LL * len + g] = lead ? 1 + (cp >= 0x10000) : 0;
    }
  }
  err = block_max(err, red);
  if (threadIdx.x == 0) errs[tile] = err;
}

// Replaces utf16_encode.py::utf16_encode_kernel: stages/utf16.py::
// encode_tile per lane.  planes holds the candidate bytes b0..b3 and the
// length L (0 at a low half its high half consumed), len lanes each.
template <typename T>
__global__ void __launch_bounds__(THREADS)
encode_kernel(const T* __restrict__ x, int n, int len,
              int* __restrict__ planes, int* __restrict__ errs) {
  __shared__ int32_t s[1 + TILE + 1];
  __shared__ int red[WARPS];
  const int tile = blockIdx.x;
  load_legacy<T, 1, 1>(x, n, tile, s);
  __syncthreads();
  int err = 0;
#pragma unroll
  for (int k = 0; k < LEGACY_ITEMS; ++k) {
    const int lane = k * THREADS + threadIdx.x;
    const int32_t* p = s + 1 + lane;
    const int u = p[0], prv = p[-1], nxt = p[1];
    const bool is_hi = (u >> 10) == 0x36, is_lo = (u >> 10) == 0x37;
    const bool prv_is_hi = (prv >> 10) == 0x36;
    const int32_t cp = is_hi ? utf16_pair_cp(u, nxt) : u;
    const int L = unit_len<UTF8>(cp);
    err |= (is_hi && (nxt >> 10) != 0x37) || (is_lo && !prv_is_hi);
    const long long g = static_cast<long long>(tile) * TILE + lane;
    if (g < len) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        planes[j * static_cast<long long>(len) + g] =
            j < L ? encode_unit<UTF8>(cp, j) : 0;
      }
      planes[4LL * len + g] = (is_lo && prv_is_hi) ? 0 : L;
    }
  }
  err = block_max(err, red);
  if (threadIdx.x == 0) errs[tile] = err;
}

// ---------------------------------------------------------------------------
// Launchers, one per kernel and cell (the geometry G is deduced from the
// argument).

template <int S, int D, class G>
int launch_count(const void* x, G geo, int nblk, int replace, int validate,
                 int ascii, int* tot, int* err, int* ferr,
                 cudaStream_t stream) {
  count_kernel<S, D, G><<<(nblk + CTILES - 1) / CTILES, THREADS, 0, stream>>>(
      static_cast<const typename Storage<S>::T*>(x), geo, nblk, replace,
      validate, ascii, tot, err, ferr);
  return static_cast<int>(cudaGetLastError());
}

template <int S, int D, class G>
int launch_write(const void* x, G geo, int nblk, int replace, int ascii,
                 const int* base, int cap, void* out, cudaStream_t stream) {
  write_kernel<S, D, G><<<(nblk + CTILES - 1) / CTILES, THREADS, 0, stream>>>(
      static_cast<const typename Storage<S>::T*>(x), geo, nblk, replace,
      ascii, base, cap, static_cast<typename Storage<D>::T*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Blocks of onepass_tail_kernel: enough for one 16-byte store a thread over
// the whole output, at most ZERO_BLOCKS (the grid-stride loop does the
// rest); most exit at once when the count is near cap.
constexpr long long ZERO_BLOCKS = 1056;

template <int S, int D, class G>
int launch_onepass(const void* x, G geo, int nblk, int replace, int validate,
                   int ascii, int cap, unsigned long long* state, int* ctl,
                   int* fin, int* tot, int* err, int* ferr, const int* end,
                   void* out, cudaStream_t stream) {
  using T = typename Storage<D>::T;
  onepass_kernel<S, D, G><<<(nblk + CTILES - 1) / CTILES, THREADS, 0,
                            stream>>>(
      static_cast<const typename Storage<S>::T*>(x), geo, nblk, replace,
      validate, ascii, cap, state, ctl, fin, tot, err, ferr,
      static_cast<T*>(out));
  const long long chunks = (static_cast<long long>(cap) * sizeof(T) + 15) / 16;
  const long long want = (chunks + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 1 ? 1
                                      : want < ZERO_BLOCKS ? want
                                                           : ZERO_BLOCKS);
  onepass_tail_kernel<T><<<blocks, THREADS, 0, stream>>>(
      end, G::packed ? nullptr : ctl, fin, cap, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_validate(const void* x, int n, int nblk, int* errs,
                    cudaStream_t stream) {
  validate_kernel<T><<<(nblk + CTILES - 1) / CTILES, THREADS, 0, stream>>>(
      static_cast<const T*>(x), n, nblk, errs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_decode(const void* x, int n, int len, int nblk, int* planes,
                  int* errs, cudaStream_t stream) {
  decode_kernel<T><<<nblk, THREADS, 0, stream>>>(
      static_cast<const T*>(x), n, len, planes, errs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_encode(const void* x, int n, int len, int nblk, int* planes,
                  int* errs, cudaStream_t stream) {
  encode_kernel<T><<<nblk, THREADS, 0, stream>>>(
      static_cast<const T*>(x), n, len, planes, errs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The legacy kernels' input element type: 0 the op's wire type NARROW
// (uint8 for UTF-8, uint16 for UTF-16), 1 int32.
#define ELEMENT_CASES(NARROW, FN, ...)                                    \
  switch (element) {                                                      \
    case 0: return FN<NARROW>(__VA_ARGS__);                               \
    case 1: return FN<int32_t>(__VA_ARGS__);                              \
    default: return static_cast<int>(cudaErrorInvalidValue);              \
  }

#define PAIR_CASES(FN, ...)                                               \
  switch (src * 4 + dst) {                                                \
    case UTF8 * 4 + UTF16: return FN<UTF8, UTF16>(__VA_ARGS__);           \
    case UTF8 * 4 + UTF32: return FN<UTF8, UTF32>(__VA_ARGS__);           \
    case UTF8 * 4 + LATIN1: return FN<UTF8, LATIN1>(__VA_ARGS__);         \
    case UTF16 * 4 + UTF8: return FN<UTF16, UTF8>(__VA_ARGS__);           \
    case UTF16 * 4 + UTF32: return FN<UTF16, UTF32>(__VA_ARGS__);         \
    case UTF16 * 4 + LATIN1: return FN<UTF16, LATIN1>(__VA_ARGS__);       \
    case UTF32 * 4 + UTF8: return FN<UTF32, UTF8>(__VA_ARGS__);           \
    case UTF32 * 4 + UTF16: return FN<UTF32, UTF16>(__VA_ARGS__);         \
    case UTF32 * 4 + LATIN1: return FN<UTF32, LATIN1>(__VA_ARGS__);       \
    case LATIN1 * 4 + UTF8: return FN<LATIN1, UTF8>(__VA_ARGS__);         \
    case LATIN1 * 4 + UTF16: return FN<LATIN1, UTF16>(__VA_ARGS__);       \
    case LATIN1 * 4 + UTF32: return FN<LATIN1, UTF32>(__VA_ARGS__);       \
    default: return static_cast<int>(cudaErrorInvalidValue);              \
  }

extern "C" {

// Copy the three 16-entry nibble tables (host int32 arrays) into the
// current device's constant memory.
int transcode_set_tables(const int32_t* byte_1_high, const int32_t* byte_1_low,
                         const int32_t* byte_2_high) {
  const size_t bytes = 16 * sizeof(int32_t);
  cudaError_t rc = cudaMemcpyToSymbol(kKL, byte_1_high, bytes, 0);
  if (rc == cudaSuccess) rc = cudaMemcpyToSymbol(kKL, byte_1_low, bytes, bytes);
  if (rc == cudaSuccess) {
    rc = cudaMemcpyToSymbol(kKL, byte_2_high, bytes, 2 * bytes);
  }
  // The same entries as bytes, four a word, for validate_kernel's PRMT
  // lookups (every entry fits a byte).
  uint32_t packed[12] = {};
  const int32_t* tabs[3] = {byte_1_high, byte_1_low, byte_2_high};
  for (int e = 0; e < KL_ENTRIES; ++e) {
    packed[e / 4] |= (static_cast<uint32_t>(tabs[e / 16][e % 16]) & 0xFFu)
                     << (8 * (e % 4));
  }
  if (rc == cudaSuccess) rc = cudaMemcpyToSymbol(kKLB, packed, sizeof packed);
  return static_cast<int>(rc);
}

// The single-buffer entry points take ascii: 0 keeps every tile out of
// the ASCII class (the wrappers' ascii_fastpath=False), 1 lets tile_class
// choose it.  The packed ones always let it.
int transcode_count(int src, int dst, const void* x, int n, int nblk,
                    int replace, int validate, int ascii, int* tot, int* err,
                    int* ferr, void* stream) {
  PAIR_CASES(launch_count, x, Flat{n}, nblk, replace, validate, ascii, tot,
             err, ferr, static_cast<cudaStream_t>(stream))
}

int transcode_write(int src, int dst, const void* x, int n, int nblk,
                    int replace, int ascii, const int* base, int cap,
                    void* out, void* stream) {
  PAIR_CASES(launch_write, x, Flat{n}, nblk, replace, ascii, base, cap, out,
             static_cast<cudaStream_t>(stream))
}

// The one-pass entry point: state holds nblk look-back words and ctl 4
// ints after it, all zero (onepass_kernel); fin receives (count, status).
int transcode_onepass(int src, int dst, const void* x, int n, int nblk,
                      int replace, int validate, int ascii, int cap,
                      unsigned long long* state, int* ctl, int* fin,
                      void* out, void* stream) {
  PAIR_CASES(launch_onepass, x, Flat{n}, nblk, replace, validate, ascii, cap,
             state, ctl, fin, nullptr, nullptr, nullptr, fin, out,
             static_cast<cudaStream_t>(stream))
}

// The packed-batch entry points: `len` elements of data in `nblk` tiles,
// with the int32 [nblk] ownership arrays of packing.tile_ownership.
int transcode_rcount(int src, int dst, const void* x, int len, int nblk,
                     const int* tile_end, const int* same_prev,
                     const int* same_next, int replace, int validate,
                     int* tot, int* err, int* ferr, void* stream) {
  const Packed geo{len, nblk, tile_end, same_prev, same_next};
  PAIR_CASES(launch_count, x, geo, nblk, replace, validate, 1, tot, err,
             ferr, static_cast<cudaStream_t>(stream))
}

int transcode_rwrite(int src, int dst, const void* x, int len, int nblk,
                     const int* tile_end, const int* same_prev,
                     const int* same_next, int replace, const int* base,
                     int cap, void* out, void* stream) {
  const Packed geo{len, nblk, tile_end, same_prev, same_next};
  PAIR_CASES(launch_write, x, geo, nblk, replace, 1, base, cap, out,
             static_cast<cudaStream_t>(stream))
}

// state holds nblk look-back words and ticket 1 int, all zero.  The end
// of the output is the last tile's INCLUSIVE value: the low word of
// state[nblk - 1] (the flags sit in bits 32-33; the card is little-endian).
int transcode_ronepass(int src, int dst, const void* x, int len, int nblk,
                       const int* tile_end, const int* same_prev,
                       const int* same_next, int replace, int validate,
                       int cap, unsigned long long* state, int* ticket,
                       int* tot, int* err, int* ferr, void* out,
                       void* stream) {
  const Packed geo{len, nblk, tile_end, same_prev, same_next};
  const int* end = reinterpret_cast<const int*>(state + nblk - 1);
  PAIR_CASES(launch_onepass, x, geo, nblk, replace, validate, 1, cap,
             state, ticket, nullptr, tot, err, ferr, end, out,
             static_cast<cudaStream_t>(stream))
}

// The legacy entry points: `n` live elements of an input of `len`, in
// `nblk` tiles; `errs` takes one int32 per tile, `planes` 3 (decode) or 5
// (encode) int32 planes of `len` lanes.
int legacy_validate(int element, const void* x, int n, int nblk, int* errs,
                    void* stream) {
  ELEMENT_CASES(uint8_t, launch_validate, x, n, nblk, errs,
                static_cast<cudaStream_t>(stream))
}

int legacy_decode(int element, const void* x, int n, int len, int nblk,
                  int* planes, int* errs, void* stream) {
  ELEMENT_CASES(uint8_t, launch_decode, x, n, len, nblk, planes, errs,
                static_cast<cudaStream_t>(stream))
}

int legacy_encode(int element, const void* x, int n, int len, int nblk,
                  int* planes, int* errs, void* stream) {
  ELEMENT_CASES(uint16_t, launch_encode, x, n, len, nblk, planes, errs,
                static_cast<cudaStream_t>(stream))
}

}  // extern "C"
