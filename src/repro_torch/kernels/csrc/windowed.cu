// Hand-written Hopper (sm_90a) kernels of the windowed strategy: the
// paper's serial walks (Lemire & Mula, Algorithms 2-4), one warp each.
//
//   windowed_utf8_kernel   replaces the lax.while_loop walk of
//                          src/repro/core/windowed.py::utf8_to_utf16_windowed
//                          a 64-byte ASCII fast path, else a 12-byte window
//                          whose end-of-character bitset keys the window
//                          table and decodes up to six characters; then a
//                          scalar tail of fewer than 12 bytes.
//   windowed_utf16_kernel  replaces the walk of
//                          src/repro/core/windowed.py::utf16_to_utf8_windowed
//                          8-unit registers, branching on the register's
//                          class: ASCII / <= U+07FF / BMP / surrogates.
//
// Neither is a Pallas kernel in the reference: each is one device-side
// loop whose next position depends on the window just read.  In torch ops
// that loop would cost a launch and a host sync per window, so the
// counterpart of the device loop is one kernel of one block of one warp
// that walks the whole buffer.  The walk stays serial; the warp works
// across each step:
//
//   UTF-8:  lanes hold the 64 bytes at p, two each; the ASCII test is an
//           __all_sync, the window key a __ballot_sync of twelve lanes'
//           end bits, six lanes decode one character each (the bytes come
//           by shuffles), a prefix sum gives each character's unit offset
//           and the lanes store.
//   UTF-16: eight lanes hold the register, its class comes from votes,
//           each lane encodes its unit and a prefix sum places the bytes.
//
// What bounds them: not the bytes (a few per cycle of one SM at most) but
// the latency of one step, times the steps (windows or registers) of the
// walk.  The table is 4096 words (16 KiB, one per key: the number of
// characters and their lengths, core/tables.py::window_packed), copied to
// shared memory once; every lane reads the same word, so the read is a
// broadcast.
//
// Semantics are those of the reference's walk, on malformed input too:
// int32 lanes, elements at and past n read as 0, arithmetic shifts and
// wrapping sums; every store writes the reference's whole window (64, 12,
// 2 or 24 elements) at min(q, cap - width), where dynamic_update_slice
// clamps it.  On UTF-8 bytes q never passes p, but an int32 input may hold
// values >= 0x10000, each a 1-byte character of two units, and then q
// passes p and the store clamps.  The output arrives zeroed; the kernel
// zeroes what its stores left past the final count, so the buffer is 0
// from count on, as the reference masks it.
//
// The C entry points return cudaGetLastError() after the launch; the
// Python wrappers (src/repro_torch/core/windowed.py) raise when it is not 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WINDOW = 12;               // bytes keyed by one table entry
constexpr int BLOCK = 64;                // ASCII fast-path block
constexpr int KEYS = 1 << WINDOW;
constexpr int REGISTER = 8;              // UTF-16 units per register
constexpr int REG_BYTES = 24;            // a register's byte store
constexpr int STATUS_OK = -1;
constexpr int PREFETCH = 1024;           // elements ahead of the walk

// UTF-8 sequence length by lead byte >> 3 (core/tables.py::LEAD_LENGTH_32).
__constant__ int kLeadLength[32] = {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0,
                                    0, 0, 2, 2, 2, 2, 3, 3, 4, 0};

// int32 arithmetic that wraps, as the reference's does.
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wshl(int a, int s) {
  return static_cast<int>(static_cast<unsigned>(a) << s);
}

// Element i of the masked input: 0 at and past n.
template <typename T>
__device__ __forceinline__ int at(const T* x, int i, int n) {
  return i < n ? static_cast<int>(x[i]) : 0;
}

template <typename T>
__device__ __forceinline__ void prefetch(const T* x, int i, int n) {
  if (i < n) asm volatile("prefetch.L1 [%0];" ::"l"(x + i));
}

// Paper Figs. 2-4: the code point of a character of `len` bytes b0..b3
// (0 when len is 0).
__device__ __forceinline__ int decode_char(int len, int b0, int b1, int b2,
                                           int b3) {
  switch (len) {
    case 1: return b0;
    case 2: return ((b0 & 0x1F) << 6) | (b1 & 0x3F);
    case 3: return ((b0 & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F);
    case 4:
      return ((b0 & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6) |
             (b3 & 0x3F);
    default: return 0;
  }
}

// Exclusive prefix sum of v over the warp's lanes; *total gets the sum.
__device__ __forceinline__ int warp_exclusive(int v, int lane, int* total) {
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += t;
  }
  *total = __shfl_sync(FULL, incl, 31);
  return incl - v;
}

__device__ __forceinline__ int final_status(const int* status0, int validate,
                                            bool err) {
  if (!validate) return STATUS_OK;
  const int s0 = *status0;
  return s0 >= 0 ? s0 : (err ? 0 : STATUS_OK);
}

// ---------------------------------------------------------------------------
// UTF-8 -> UTF-16 (Algorithms 2 and 3).

template <typename T>
__global__ void __launch_bounds__(32)
    windowed_utf8_kernel(const T* __restrict__ x, int n, int cap,
                         const int* __restrict__ status0, int validate,
                         const unsigned* __restrict__ table,
                         int* __restrict__ out, int* __restrict__ fin) {
  __shared__ unsigned tab[KEYS];
  const int lane = threadIdx.x;
  for (int i = lane; i < KEYS; i += 32) tab[i] = table[i];
  __syncwarp();
  int p = 0, q = 0;
  bool err = false;
  while (p + WINDOW <= n) {
    if (lane == 0) prefetch(x, p + PREFETCH, n);
    // Lane l holds bytes p + l and p + 32 + l.
    const int v0 = at(x, p + lane, n), v1 = at(x, p + 32 + lane, n);
    if (p + BLOCK <= n && __all_sync(FULL, v0 < 0x80 && v1 < 0x80)) {
      const int s = min(q, cap - BLOCK);
      out[s + lane] = v0;
      out[s + 32 + lane] = v1;
      p += BLOCK;
      q += BLOCK;
      __syncwarp();   // orders this step's stores before the next one's
      continue;
    }
    // End-of-character bitset of the window: byte i ends a character iff
    // byte i + 1 is no continuation byte or lies past the end (lane i
    // holds byte p + 1 + i).
    const int nx = __shfl_down_sync(FULL, v0, 1);
    const bool ends = (nx & 0xC0) != 0x80 || p + 1 + lane >= n;
    const unsigned e = tab[__ballot_sync(FULL, ends) & (KEYS - 1)];
    const int nch = e & 7;
    int start = 0, consumed = 0;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int len = (e >> (3 + 3 * j)) & 7;
      start += j < lane ? len : 0;
      consumed += len;
    }
    // Lane j < nch decodes character j from the bytes at p + start.
    const int len = lane < 6 ? (e >> (3 + 3 * lane)) & 7 : 0;
    const int b0 = __shfl_sync(FULL, v0, start);
    const int b1 = __shfl_sync(FULL, v0, start + 1);
    const int b2 = __shfl_sync(FULL, v0, start + 2);
    const int b3 = __shfl_sync(FULL, v0, start + 3);
    const int cp = decode_char(len, b0, b1, b2, b3);
    const bool live = lane < nch;
    const bool supp = cp >= 0x10000;
    int woff;
    const int off = warp_exclusive(live ? 1 + supp : 0, lane, &woff);
    // The window's 12 units: the characters' units, zeros after them.
    const int s = min(q, cap - WINDOW);
    if (live) {
      const int v = wadd(cp, -0x10000);
      out[s + off] = supp ? 0xD800 + (v >> 10) : cp;
      if (supp) out[s + off + 1] = 0xDC00 + (v & 0x3FF);
    }
    if (lane >= woff && lane < WINDOW) out[s + lane] = 0;
    err |= nch == 0;                 // no character: an invalid key
    p += max(consumed, 1);           // always make progress
    q += woff;
    __syncwarp();
  }
  // The conventional tail (< 12 bytes), one character a step on lane 0.
  if (lane == 0) {
    while (p < n) {
      const int w0 = at(x, p, n);
      const int idx = w0 >> 3;       // jnp.take: wraps negatives, fills
      int len = idx >= -32 && idx < 32 ? kLeadLength[idx & 31] : INT32_MIN;
      err |= len == 0;
      len = min(max(len, 1), n - p);
      const int cp = decode_char(len, w0, at(x, p + 1, n), at(x, p + 2, n),
                                 at(x, p + 3, n));
      const bool supp = cp >= 0x10000;
      const int v = wadd(cp, -0x10000);
      const int s = min(q, cap - 2);
      out[s] = supp ? 0xD800 + (v >> 10) : cp;
      out[s + 1] = supp ? 0xDC00 + (v & 0x3FF) : 0;
      p += len;
      q += 1 + supp;
    }
  }
  q = __shfl_sync(FULL, q, 0);
  err = __shfl_sync(FULL, err, 0);
  __syncwarp();
  // The stores reach at most 64 elements past the final count.
  for (int i = q + lane; i < min(q + BLOCK, cap); i += 32) out[i] = 0;
  if (lane == 0) {
    fin[0] = q;
    fin[1] = final_status(status0, validate, err);
  }
}

// ---------------------------------------------------------------------------
// UTF-16 -> UTF-8 (Algorithm 4).

// The j-th byte of a character of L bytes (Algorithm 4's case routines).
__device__ __forceinline__ int utf8_byte(int cp, int L, int j) {
  const int c0 = cp & 0x3F, c1 = (cp >> 6) & 0x3F, c2 = (cp >> 12) & 0x3F;
  switch (L) {
    case 1: return j == 0 ? cp : 0;
    case 2: return j == 0 ? 0xC0 | (cp >> 6) : j == 1 ? 0x80 | c0 : 0;
    case 3:
      return j == 0 ? 0xE0 | (cp >> 12) : j == 1 ? 0x80 | c1
             : j == 2 ? 0x80 | c0 : 0;
    default:
      return j == 0 ? 0xF0 | ((cp >> 18) & 0x07) : j == 1 ? 0x80 | c2
             : j == 2 ? 0x80 | c1 : 0x80 | c0;
  }
}

template <typename T>
__global__ void __launch_bounds__(32)
    windowed_utf16_kernel(const T* __restrict__ x, int n, int cap,
                          const int* __restrict__ status0, int validate,
                          int* __restrict__ out, int* __restrict__ fin) {
  const int lane = threadIdx.x;
  int p = 0, q = 0;
  bool err = false;
  while (p < n) {
    if (lane == 0) prefetch(x, p + PREFETCH, n);
    // Lanes 0-7 hold the register; the others hold 0 and take no part.
    const bool reg_lane = lane < REGISTER;
    const int r = reg_lane ? at(x, p + lane, n) : 0;
    const bool hi = reg_lane && (r >> 10) == 0x36;
    const bool lo = reg_lane && (r >> 10) == 0x37;
    int L, cp = r, take = REGISTER;
    if (__all_sync(FULL, r < 0x80)) {
      // Case 0, ASCII: the register itself.
      L = reg_lane ? 1 : 0;
    } else if (!__any_sync(FULL, hi || lo)) {
      // Cases 1 and 2, BMP without surrogates: 1-3 bytes a unit.
      L = reg_lane ? 1 + (r >= 0x80) + (r >= 0x800) : 0;
    } else {
      // Case 3, surrogates present (the paper's scalar fallback, across
      // the lanes): fold pairs, emit from each character's first unit.
      const int down = __shfl_down_sync(FULL, r, 1);
      const int nxt = lane < REGISTER - 1 ? down : 0;
      const bool nxt_lo = (nxt >> 10) == 0x37;
      const bool prv_hi = __shfl_up_sync(FULL, hi, 1) && lane > 0;
      // Do not split a pair: a register ending in an unconsumed high half
      // stops at lane 7.
      take = __shfl_sync(FULL, hi && !prv_hi, REGISTER - 1) ? REGISTER - 1
                                                             : REGISTER;
      const bool live = lane < take;
      const bool lead = live && !(lo && prv_hi);
      const int pair = wadd(wadd(0x10000, wshl(wadd(r, -0xD800), 10)),
                            wadd(nxt, -0xDC00));
      cp = hi ? pair : r;
      err |= __any_sync(FULL, (live && hi && !nxt_lo && lane < take - 1) ||
                                  (live && lo && !prv_hi) ||
                                  (lead && hi && lane == take - 1));
      L = lead ? 1 + (cp >= 0x80) + (cp >= 0x800) + (cp >= 0x10000) : 0;
    }
    int total;
    const int start = warp_exclusive(L, lane, &total);
    // The register's 24 bytes: the characters' bytes (those past 24
    // dropped), zeros after them.
    const int s = min(q, cap - REG_BYTES);
    for (int j = 0; j < L && start + j < REG_BYTES; ++j)
      out[s + start + j] = utf8_byte(cp, L, j);
    if (lane >= total && lane < REG_BYTES) out[s + lane] = 0;
    // Near the end the register is partly filled: the units consumed are
    // clamped, and the bytes advanced are recounted over them (a high
    // half counts 4, a low half 0).
    const int k = min(take, n - p);
    const int per_unit = hi ? 4 : lo ? 0 : 1 + (r >= 0x80) + (r >= 0x800);
    q += static_cast<int>(__reduce_add_sync(
        FULL, static_cast<unsigned>(lane < k ? per_unit : 0)));
    p += max(k, 1);
    __syncwarp();   // orders this step's stores before the next one's
  }
  // The stores reach at most 24 elements past the final count.
  for (int i = q + lane; i < min(q + REG_BYTES, cap); i += 32) out[i] = 0;
  if (lane == 0) {
    fin[0] = q;
    fin[1] = final_status(status0, validate, err);
  }
}

template <typename T>
int launch_utf8(const void* x, int n, int cap, const int* status0,
                int validate, const unsigned* table, int* out, int* fin,
                cudaStream_t stream) {
  windowed_utf8_kernel<T><<<1, 32, 0, stream>>>(
      static_cast<const T*>(x), n, cap, status0, validate, table, out, fin);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_utf16(const void* x, int n, int cap, const int* status0,
                 int validate, int* out, int* fin, cudaStream_t stream) {
  windowed_utf16_kernel<T><<<1, 32, 0, stream>>>(
      static_cast<const T*>(x), n, cap, status0, validate, out, fin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The input element type: 0 the direction's wire type NARROW (uint8 for
// UTF-8, uint16 for UTF-16), 1 int32.
#define WINDOWED_ELEMENT_CASES(NARROW, FN, ...)                           \
  switch (element) {                                                      \
    case 0: return FN<NARROW>(__VA_ARGS__);                               \
    case 1: return FN<int32_t>(__VA_ARGS__);                              \
    default: return static_cast<int>(cudaErrorInvalidValue);              \
  }

extern "C" {

// UTF-8 -> UTF-16 walk over x[0, n): out (int32, cap = len + 80, zeroed
// by the caller), fin = (count, status).  status0 is the whole-array
// first-error offset (read only when validate); table the 4096 packed
// window entries.
int windowed_utf8(int element, const void* x, int n, int cap,
                  const int* status0, int validate, const unsigned* table,
                  int* out, int* fin, void* stream) {
  WINDOWED_ELEMENT_CASES(uint8_t, launch_utf8, x, n, cap, status0, validate,
                         table, out, fin, static_cast<cudaStream_t>(stream))
}

// UTF-16 -> UTF-8 walk over x[0, n): out (int32, cap = 3 len + 24, zeroed
// by the caller), fin = (count, status).
int windowed_utf16(int element, const void* x, int n, int cap,
                   const int* status0, int validate, int* out, int* fin,
                   void* stream) {
  WINDOWED_ELEMENT_CASES(uint16_t, launch_utf16, x, n, cap, status0,
                         validate, out, fin,
                         static_cast<cudaStream_t>(stream))
}

}  // extern "C"
