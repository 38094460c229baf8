// Hand-written Hopper (sm_90a) kernels of causal flash attention, both on
// the tensor cores:
//
//   flash_tc_kernel<D>    bfloat16: bf16 wgmma
//   flash_tf32_kernel<D>  float32: error-compensated TF32 wgmma (3xTF32)
//
// Both replace src/repro/kernels/flash_attention.py::_flash_kernel:
// causal attention with an optional sliding window, an online softmax in
// f32 over key chunks, masked with the reference's finite NEG_INF, output
// cast to the input's type.  Head dims 32, 64, 80 and 128.  q is
// (B, Sq, H, D), k and v (B, Sk, H, D), o like q, all contiguous; TMA
// reads them with their strides, so no transposed copy is made.  Blocks
// tile (batch * head, query rows): two warpgroups of 64 query rows share
// each K/V chunk; the last query rows (the most keys) launch first.
//
// What bounds them: operations.  A causal pass does 4 * D flops per live
// (query, key) pair per head; at the qwen3-8b width (S = 4096, 32 heads
// of 128) that is 137.5 GFLOP: 0.139 ms at the bf16 tensor-core peak
// (989 TFLOP/s), and for f32 three TF32 products of it at the TF32 peak
// (495 TFLOP/s): 0.833 ms, against 0.04 ms of bytes in bf16.
//
// bf16 (flash_tc_kernel): S = Q K^T is wgmma m64n64k16 with Q and K from
// shared memory (both K-major, the rows' own layout); O += P V is wgmma
// m64nDk16 with P from registers (the S accumulator's fragment is P's A
// fragment) and V from shared memory, MN-major through the transpose bit.
// K/V chunks of 64 keys are staged by TMA into a two-stage ring with an
// mbarrier per stage, so the next chunk's copy overlaps this chunk's
// products; the warpgroup that releases a stage last issues its refill, so
// neither waits on the other.  The query tiles come the same way, once.
// Shared memory holds bf16 tiles as slabs of 64 columns, [64 rows][128
// bytes], in the 128-byte swizzle that TMA writes and wgmma reads, for
// every head dim: a four-dimensional tensor map (D, S, H, B) reads 64
// columns at a time and fills columns past D with zeros, so D = 80 (160
// bytes a row, which fits neither the 128-byte swizzle nor a power-of-two
// box) is two slabs, the second 16 columns wide, and D = 32 half a slab.
// The products read only the first D columns.  Descriptors: Q and K step
// through a slab 32 bytes (16 columns) at a time, 8-row groups 1024 bytes
// apart (SBO); V's next 16 keys are 2048 bytes on, its next 8 keys 1024
// (SBO), its next 64 columns one slab (LBO).  Rows narrower than 128 bytes
// cost TMA time, which is why this layout, not 16-byte core-matrix
// columns, stages every head dim.
//   Numerics: the products of bf16 q and k are exact in the f32
// accumulator, and the scores are scaled after it (by 1/sqrt(D) * log2 e,
// so the softmax runs on exp2); the reference scales q in f32 first, a
// difference of f32 rounding only.  P is fed to the P V product as
// p_hi = bf16(p) and p_lo = bf16(p - p_hi), two products into one f32
// accumulator: about 16 bits of p, where one bf16 (8 bits) would leave
// errors of 2^-9 of each term, more than the 1e-4 absolute tolerance on
// outputs near zero.  The second product is not needed work and is not
// counted in the bound.
//
// f32 (flash_tf32_kernel): one TF32 product keeps 11 bits of each operand
// (about three decimal digits), outside the reference tests' f32
// tolerance.  So every operand a is split into hi = tf32_rna(a) and lo =
// tf32_rna(a - hi), and each product is hi*lo + lo*hi + hi*hi (lo*lo
// dropped; the two small products go into the accumulator first): about
// 21 bits, at a third of the TF32 rate.  The split rounds to nearest
// (cvt.rna), since the tensor core truncates the low 13 bits of an f32
// operand and would drop the bits the split is for.  Q is scaled in f32
// (as the reference does) and split once per block, in place, into hi and
// lo tiles.  K and V chunks of 32 keys arrive by TMA into one staging
// buffer each and all 256 threads split them: K elementwise into hi and
// lo tiles of its own layout; V transposed, since a TF32 wgmma reads B
// only K-major (the transpose bit is for 16-bit types) and V is [key][d].
// Its V^T tiles are [D rows][32 keys], 128 bytes a row in the same
// swizzle.  P comes from registers: the f32 S accumulator holds columns
// 2 (t % 4) + {0, 1} of each 8-key step where a TF32 A fragment wants
// columns t % 4 and t % 4 + 4, so the keys of each step are permuted,
// column c < 4 of the A fragment taking key 2c and column c + 4 key
// 2c + 1, and V^T is written in the same permuted order: no shuffle, and
// the sum over keys is unchanged.  Tiles are slabs of 32 columns [rows]
// [128 bytes] (D = 80 is three slabs, the last 16 columns wide, zero-
// filled past D); descriptors step 32 bytes (8 columns) through a slab,
// 8-row groups 1024 bytes apart.  The staging buffers free up when the
// split is done, so the next chunk's copy overlaps this chunk's products.
// 2 x (Q hi + lo) + K, V staging + K hi, lo + V^T hi, lo take 224 KiB at
// D = 128: one block a SM.
//
// The key range of a query row is the reference's: keys [lo*bk, hi*bk)
// for the reference's query tile of bq rows (bq % 64 == 0, bk % 32 == 0).
// Keys outside it carry zero weight; they are not masked with NEG_INF (the
// bf16 kernel's 64-key chunks may straddle lo*bk or hi*bk and exclude the
// outside keys with -inf; keys past Sk arrive as TMA's zero fill; the f32
// kernel's 32-key chunks never straddle them).  Within it a warpgroup
// skips chunks that are masked for all of its rows when each of its rows
// has a live key; that leaves every result bit unchanged (their p are
// exp(-1e30 - m) = 0, or they precede a live chunk whose correction
// exp(-1e30 - m) = 0 wipes them).  Rows with no live key keep the
// reference's uniform average over the range, since every chunk is then
// computed with the finite NEG_INF.
//
// The C entry point returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda.h>             // CUtensorMap; the encoder is fetched at run
#include <cuda_bf16.h>        // time, so the build needs no -lcuda
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f; // the reference's finite mask value

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core body.

constexpr int TC_ROWS = 64;       // query rows per warpgroup, keys per chunk
constexpr int TC_GROUPS = 2;      // consumer warpgroups per block
constexpr int TC_THREADS = 128 * TC_GROUPS;
constexpr int TC_STAGES = 2;      // K/V ring depth
constexpr int SWIZZLE_ATOM = 1024; // 8 rows x 128 bytes
constexpr float LOG2E = 1.4426950408889634f;

// A 64-row bf16 tile of head dim D in shared memory: ceil(D / 64) slabs of
// 64 columns, each [64 rows][128 bytes] in the 128-byte swizzle that TMA
// writes and wgmma reads; columns past D (the second slab of D = 80, half
// the slab of D = 32) are TMA's zero fill and never read by a product.
constexpr int SLAB = TC_ROWS * 128;

template <int D>
struct TcTile {
  static constexpr int SLABS = (D + 63) / 64;
  static constexpr int BYTES = SLABS * SLAB;
};

template <int D>
constexpr int tc_smem_bytes() {
  // Query tiles, the K/V ring, the barriers and release counts, and room
  // to align to the swizzle atom.
  return (TC_GROUPS + 2 * TC_STAGES) * TcTile<D>::BYTES
       + (1 + TC_STAGES) * 8 + TC_STAGES * 4 + SWIZZLE_ATOM;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor of the 128-byte-swizzle canonical layout (type
// 1): start address, LBO and SBO in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4)
       | static_cast<uint64_t>(lbo >> 4) << 16
       | static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// Q or K over k16 step t: K-major; the step's 16 columns are 32 bytes of
// a swizzled row of slab t / 4 (LBO unused), 8-row groups 1024 bytes apart
// (SBO).
__device__ __forceinline__ uint64_t desc_k_major(const uint8_t* tile,
                                                 int t) {
  return desc_sw128(tile + t / 4 * SLAB + t % 4 * 32, 16, 1024);
}

// V over k16 step ks (16 keys, 2048 bytes): MN-major; the next 8 keys 1024
// bytes on (SBO), the next 64 columns one slab on (LBO).
__device__ __forceinline__ uint64_t desc_mn_major(const uint8_t* tile,
                                                  int ks) {
  return desc_sw128(tile + ks * 2048, SLAB, 1024);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(phase) : "memory");
  }
}

// One TMA box of a (B, S, H, D) tensor map into shared memory: columns
// [col, col + box) of rows [row, row + box rows) of head h of batch b;
// rows past S and columns past D read 0.  Completes on bar.
__device__ __forceinline__ void tma_box(uint8_t* dst, const CUtensorMap* map,
                                        uint64_t* bar, int col, int row,
                                        int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(col), "r"(row), "r"(h), "r"(b), "r"(smem_addr(bar))
      : "memory");
}

// One 64-row bf16 tile, rows [row, row + 64) of head h of batch b, into
// shared memory as TcTile<D> slabs, one copy per slab.  bar expects
// TcTile<D>::BYTES.
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int row, int h,
                                         int b) {
#pragma unroll
  for (int s = 0; s < TcTile<D>::SLABS; ++s) {
    tma_box(dst + s * SLAB, map, bar, 64 * s, row, h, b);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n"
               "wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from reading an accumulator before the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// 2^x on the special-function unit; results below 2^-126 flush to 0, a
// weight far below f32 resolution beside the row maximum's weight of 1.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (+)= Q K^T over one k16 step: m64n64k16, A (Q) and B (K) K-major in
// shared memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O += P V over one k16 step: m64nNk16 with N the head dim, A (P) from
// registers, B (V) MN-major in shared memory (the transpose bit).
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_pv<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<80>(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Register fragments (wgmma's accumulator layout): thread t of a
// warpgroup holds rows 16 * (t / 32) + (t % 32) / 4 + {0, 8} of its 64 and,
// for each 8-column block j, columns 8 j + 2 (t % 4) + {0, 1}; element
// 4 j + 2 r + c is (row + 8 r, column 8 j + 2 (t % 4) + c).  The k16 step s
// of P's A fragment is then elements 8 s .. 8 s + 7 of the S accumulator,
// packed in pairs.
//
// A block is TC_GROUPS warpgroups over TC_GROUPS * 64 query rows; they
// share each K/V chunk.  Warpgroup w visits the chunks of its own key
// range (they differ on the diagonal, and across reference tiles when
// bq = 64) and idles through the others, so its arithmetic is that of a
// block of its own.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int H, int Sq, int Sk, int bq,
                int bk, int has_window, int window, float scale_log2) {
  static_assert(D % 16 == 0 && D <= 128, "head dim");
  constexpr int TILE = TcTile<D>::BYTES;          // bytes of a 64-row tile
  extern __shared__ uint8_t smem_raw[];
  // Swizzled tiles start on a swizzle atom.
  uint8_t* Qs = smem_raw + (-smem_addr(smem_raw) & (SWIZZLE_ATOM - 1));
  uint8_t* Ks = Qs + TC_GROUPS * TILE;            // [TC_STAGES] tiles
  uint8_t* Vs = Ks + TC_STAGES * TILE;            // [TC_STAGES] tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + TC_STAGES * TILE);
  uint64_t* kv_full = q_full + 1;                 // [TC_STAGES]
  // Warpgroups done with each stage's chunk.
  int* released = reinterpret_cast<int*>(kv_full + TC_STAGES);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qb = (gridDim.y - 1 - blockIdx.y) * TC_GROUPS * TC_ROWS;
  const int q0 = qb + wg * TC_ROWS;               // this warpgroup's rows
  const int q_last = q0 + TC_ROWS - 1;
  const int row0 = q0 + 16 * warp + (lane >> 2);  // and row0 + 8
  const int col0 = 2 * (lane & 3);                // and col0 + 1

  // The reference's live keys [ref_lo, ref_hi) of this warpgroup's query
  // tile, and its keys to visit: narrowed to [key_lo, key_hi) when every
  // row has a live key (its own, on the diagonal).  Rows past Sq (the
  // last block when Sq % 128 == 64) visit nothing.
  const int qi = q0 / bq;
  const int hi = min(Sk / bk, (qi + 1) * bq / bk + (bq % bk ? 1 : 0));
  const int lo_t = qi * bq - window;
  const int lo = (has_window && lo_t > 0) ? lo_t / bk : 0;
  const int ref_lo = lo * bk, ref_hi = hi * bk;
  int key_lo = ref_lo, key_hi = q0 < Sq ? ref_hi : 0;
  if (q_last < Sk && (!has_window || window >= 1)) {
    key_hi = min(key_hi, q_last + 1);
    if (has_window) key_lo = max(key_lo, q0 - window + 1);
  }
  const int my_first = key_lo / TC_ROWS * TC_ROWS;
  const bool active = key_hi > key_lo;
  // The block's chunks: the union of its warpgroups'.
  __shared__ int first_sh[TC_GROUPS], end_sh[TC_GROUPS];
  if ((tid & 127) == 0) {
    first_sh[wg] = active ? my_first : INT32_MAX;
    end_sh[wg] = active ? key_hi : INT32_MIN;
  }
  __syncthreads();
  int c0 = INT32_MAX, c_end = INT32_MIN;
#pragma unroll
  for (int w = 0; w < TC_GROUPS; ++w) {
    c0 = min(c0, first_sh[w]);
    c_end = max(c_end, end_sh[w]);
  }
  const int chunks = c_end > c0 ? (c_end - c0 + TC_ROWS - 1) / TC_ROWS : 0;

  if (tid == 0) {
    mbar_init(q_full);
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(&kv_full[s]);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(q_full, TC_GROUPS * TILE);
    for (int w = 0; w < TC_GROUPS; ++w) {
      tma_tile<D>(Qs + w * TILE, &tq, q_full, qb + w * TC_ROWS, h, b);
    }
    for (int s = 0; s < TC_STAGES && s < chunks; ++s) {
      mbar_expect(&kv_full[s], 2 * TILE);
      tma_tile<D>(Ks + s * TILE, &tk, &kv_full[s], c0 + s * TC_ROWS, h, b);
      tma_tile<D>(Vs + s * TILE, &tv, &kv_full[s], c0 + s * TC_ROWS, h, b);
    }
  }

  const uint8_t* Qw = Qs + wg * TILE;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int i = 0; i < chunks; ++i) {
    const int st = i % TC_STAGES;
    const int kc = c0 + i * TC_ROWS;
    const uint8_t* Kst = Ks + st * TILE;
    const uint8_t* Vst = Vs + st * TILE;
    mbar_wait(&kv_full[st], (i / TC_STAGES) & 1);

    if (active && kc >= my_first && kc < key_hi) {
      float s[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < D / 16; ++t) {
        wgmma_qk(s, desc_k_major(Qw, t), desc_k_major(Kst, t), t);
      }
      wgmma_commit_wait();
      fence_regs(s);

      // Scores in the log2 domain, s * scale: where a pair may be masked,
      // keys outside [ref_lo, ref_hi) get -inf (zero weight) and masked
      // pairs the reference's NEG_INF; in a chunk live for every pair the
      // scale is folded into the exponent's FMA (sc), and into the row
      // maximum, which it commutes with (scale > 0).
      const bool all_live = kc >= ref_lo && kc + TC_ROWS <= ref_hi
          && kc + TC_ROWS - 1 <= q0 && (!has_window || q_last - kc < window);
      const float sc = all_live ? scale_log2 : 1.f;
      if (!all_live) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int r = row0 + 8 * ((e >> 1) & 1);
          const int key = kc + 8 * (e >> 2) + col0 + (e & 1);
          if (key < ref_lo || key >= ref_hi) {
            s[e] = __int_as_float(0xff800000);  // -inf
          } else if (key > r || (has_window && r - key >= window)) {
            s[e] = NEG_INF;
          } else {
            s[e] *= scale_log2;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = NEG_INF;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mt = fmaxf(mt, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        }
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m[r], all_live ? mt * sc : mt);
        const float corr = exp2_approx(m[r] - m_new);
        m[r] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p =
                exp2_approx(fmaf(s[4 * j + 2 * r + c], sc, -m_new));
            s[4 * j + 2 * r + c] = p;
            rs += p;
          }
        }
        l[r] = l[r] * corr + rs;  // this thread's columns; summed at the end
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j + 2 * r] *= corr;
          acc[4 * j + 2 * r + 1] *= corr;
        }
      }

      // P as two bf16 fragments, hi and lo, per k16 step.
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = s[8 * ks + 2 * r], c = s[8 * ks + 2 * r + 1];
          const __nv_bfloat162 hi2 = __floats2bfloat162_rn(a, c);
          const float2 back = __bfloat1622float2(hi2);
          p_hi[ks][r] = bf16x2_bits(hi2);
          p_lo[ks][r] = bf16x2_bits(__floats2bfloat162_rn(a - back.x,
                                                          c - back.y));
        }
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t dv = desc_mn_major(Vst, ks);
        wgmma_pv<D>(acc, p_hi[ks], dv);
        wgmma_pv<D>(acc, p_lo[ks], dv);
      }
      wgmma_commit_wait();
      fence_regs(acc);
    }

    // This warpgroup is done with the stage; the last one to say so
    // refills it, so no warpgroup waits on another's chunk.
    asm volatile("bar.sync %0, 128;" :: "r"(1 + wg) : "memory");
    if ((tid & 127) == 0
        && atomicAdd(&released[st], 1) == TC_GROUPS - 1) {
      atomicExch(&released[st], 0);
      if (i + TC_STAGES < chunks) {
        mbar_expect(&kv_full[st], 2 * TILE);
        tma_tile<D>(Ks + st * TILE, &tk, &kv_full[st],
                 c0 + (i + TC_STAGES) * TC_ROWS, h, b);
        tma_tile<D>(Vs + st * TILE, &tv, &kv_full[st],
                 c0 + (i + TC_STAGES) * TC_ROWS, h, b);
      }
    }
  }

  if (q0 >= Sq) return;
  const long long stride = static_cast<long long>(H) * D;  // per position
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float denom = fmaxf(lt, 1e-30f);
    __nv_bfloat16* row =
        o + (static_cast<long long>(b) * Sq + row0 + 8 * r) * stride
          + static_cast<long long>(h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] / denom, acc[4 * j + 2 * r + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: the 3xTF32 tensor-core body.

constexpr int F_KEYS = 32;        // keys per chunk
constexpr int F_SLAB_ROW = 128;   // bytes of a slab row: 32 f32 columns

// Bytes of the f32 tiles of head dim D: a warpgroup's 64 query rows and a
// 32-key chunk as ceil(D / 32) slabs of [rows][128 bytes], and a chunk of
// V^T as D rows of 32 keys.
template <int D>
struct F32Tile {
  static constexpr int SLABS = (D + 31) / 32;
  static constexpr int Q = SLABS * TC_ROWS * F_SLAB_ROW;
  static constexpr int K = SLABS * F_KEYS * F_SLAB_ROW;
  static constexpr int VT = D * F_SLAB_ROW;
};

template <int D>
constexpr int tf32_smem_bytes() {
  // Q hi and lo per warpgroup, K and V staging, K hi and lo, V^T hi and
  // lo, two barriers, and room to align to the swizzle atom.
  return TC_GROUPS * 2 * F32Tile<D>::Q + 4 * F32Tile<D>::K
       + 2 * F32Tile<D>::VT + 2 * 8 + SWIZZLE_ATOM;
}

// a rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the f32 bit pattern with the low 13 bits zero.
__device__ __forceinline__ float tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return __uint_as_float(r);
}

// The split of four values: hi = tf32_rna(a), lo = tf32_rna(a - hi).
__device__ __forceinline__ void split4(float4 a, float4& hi, float4& lo) {
  hi = make_float4(tf32_rna(a.x), tf32_rna(a.y), tf32_rna(a.z),
                   tf32_rna(a.w));
  lo = make_float4(tf32_rna(a.x - hi.x), tf32_rna(a.y - hi.y),
                   tf32_rna(a.z - hi.z), tf32_rna(a.w - hi.w));
}

// Byte offset of element (row, col) in a tile of 32-column slabs of
// `rows` rows, in the 128-byte swizzle (16-byte chunk c of row r at
// c ^ (r % 8); the tile starts on a swizzle atom).
__device__ __forceinline__ int sw128_offset(int row, int col, int rows) {
  return col / 32 * rows * F_SLAB_ROW + row * F_SLAB_ROW
       + (((col % 32) / 4) ^ (row & 7)) * 16 + (col % 4) * 4;
}

// A K-major TF32 operand over k8 step t: the step's 8 columns are 32
// bytes of a swizzled row of slab t / 4, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_tf32(const uint8_t* tile, int t,
                                              int slab_bytes) {
  return desc_sw128(tile + t / 4 * slab_bytes + t % 4 * 32, 16, 1024);
}

template <int N>
__device__ __forceinline__ void fence_regs_u(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
  }
}

// S (+)= A B^T over one k8 step: m64n32k8 in TF32, A and B K-major in
// shared memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O += P V over one k8 step: m64nNk8 in TF32 with N the head dim, A (P)
// from registers, B (V^T, K-major) in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db);

template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(float (&d)[16],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<80>(float (&d)[40],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The block's layout and schedule follow flash_tc_kernel's: TC_GROUPS
// warpgroups of 64 query rows, the block's chunks the union of theirs,
// each warpgroup computing only the chunks of its own key range.  Per
// chunk: wait for its K and V, split them (every thread), fence the
// writes to the tensor cores' proxy, sync, issue the next chunk's copy,
// then S, the softmax and O += P V per warpgroup, and sync again before
// the next split overwrites the operands.
//
// Register fragments (wgmma's accumulator layout): thread t of a
// warpgroup holds rows 16 * (t / 32) + (t % 32) / 4 + {0, 8} and, for each
// 8-key step j, keys 8 j + 2 (t % 4) + {0, 1}: element 4 j + 2 r + c is
// (row + 8 r, key 8 j + 2 (t % 4) + c).  P's A fragment of step j is
// {4 j, 4 j + 2, 4 j + 1, 4 j + 3}: rows {0, 8, 0, 8} at permuted columns
// t % 4 (key 2 (t % 4)) and t % 4 + 4 (key 2 (t % 4) + 1).
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  float* __restrict__ o, int H, int Sq, int Sk, int bq,
                  int bk, int has_window, int window, float scale) {
  static_assert(D % 16 == 0 && D <= 128, "head dim");
  using Tile = F32Tile<D>;
  constexpr int Q_SLAB = TC_ROWS * F_SLAB_ROW;
  constexpr int K_SLAB = F_KEYS * F_SLAB_ROW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + (-smem_addr(smem_raw) & (SWIZZLE_ATOM - 1));
  uint8_t* Kin = Qs + TC_GROUPS * 2 * Tile::Q;    // K as loaded
  uint8_t* Vin = Kin + Tile::K;                   // V as loaded
  uint8_t* Khi = Vin + Tile::K;
  uint8_t* Klo = Khi + Tile::K;
  uint8_t* Vthi = Klo + Tile::K;                  // V^T, permuted keys
  uint8_t* Vtlo = Vthi + Tile::VT;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vtlo + Tile::VT);
  uint64_t* kv_full = q_full + 1;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qb = (gridDim.y - 1 - blockIdx.y) * TC_GROUPS * TC_ROWS;
  const int q0 = qb + wg * TC_ROWS;               // this warpgroup's rows
  const int q_last = q0 + TC_ROWS - 1;
  const int row0 = q0 + 16 * warp + (lane >> 2);  // and row0 + 8
  const int col0 = 2 * (lane & 3);                // and col0 + 1

  // The reference's live keys [ref_lo, ref_hi), and the keys to visit
  // [key_lo, key_hi), as in flash_tc_kernel; 32-key chunks from
  // key_lo rounded down stay inside [ref_lo, ref_hi) (bk % 32 == 0).
  const int qi = q0 / bq;
  const int hi = min(Sk / bk, (qi + 1) * bq / bk + (bq % bk ? 1 : 0));
  const int lo_t = qi * bq - window;
  const int lo = (has_window && lo_t > 0) ? lo_t / bk : 0;
  const int ref_lo = lo * bk, ref_hi = hi * bk;
  int key_lo = ref_lo, key_hi = q0 < Sq ? ref_hi : 0;
  if (q_last < Sk && (!has_window || window >= 1)) {
    key_hi = min(key_hi, q_last + 1);
    if (has_window) key_lo = max(key_lo, q0 - window + 1);
  }
  const int my_first = key_lo / F_KEYS * F_KEYS;
  const bool active = key_hi > key_lo;
  __shared__ int first_sh[TC_GROUPS], end_sh[TC_GROUPS];
  if ((tid & 127) == 0) {
    first_sh[wg] = active ? my_first : INT32_MAX;
    end_sh[wg] = active ? key_hi : INT32_MIN;
  }
  __syncthreads();
  int c0 = INT32_MAX, c_end = INT32_MIN;
#pragma unroll
  for (int w = 0; w < TC_GROUPS; ++w) {
    c0 = min(c0, first_sh[w]);
    c_end = max(c_end, end_sh[w]);
  }
  const int chunks = c_end > c0 ? (c_end - c0 + F_KEYS - 1) / F_KEYS : 0;

  if (tid == 0) {
    mbar_init(q_full);
    mbar_init(kv_full);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(q_full, TC_GROUPS * Tile::Q);
    for (int w = 0; w < TC_GROUPS; ++w) {
      for (int s = 0; s < Tile::SLABS; ++s) {
        tma_box(Qs + 2 * w * Tile::Q + s * Q_SLAB, &tq, q_full, 32 * s,
                qb + w * TC_ROWS, h, b);
      }
    }
    if (chunks > 0) {
      mbar_expect(kv_full, 2 * Tile::K);
      for (int s = 0; s < Tile::SLABS; ++s) {
        tma_box(Kin + s * K_SLAB, &tk, kv_full, 32 * s, c0, h, b);
        tma_box(Vin + s * K_SLAB, &tv, kv_full, 32 * s, c0, h, b);
      }
    }
  }

  // Scale this warpgroup's query tile in f32 and split it: hi in place,
  // lo beside it.
  uint8_t* Qhi = Qs + 2 * wg * Tile::Q;
  uint8_t* Qlo = Qhi + Tile::Q;
  mbar_wait(q_full, 0);
  for (int e = tid & 127; e < Tile::Q / 16; e += 128) {
    float4 a = reinterpret_cast<float4*>(Qhi)[e];
    a = make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
    float4 hi4, lo4;
    split4(a, hi4, lo4);
    reinterpret_cast<float4*>(Qhi)[e] = hi4;
    reinterpret_cast<float4*>(Qlo)[e] = lo4;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int i = 0; i < chunks; ++i) {
    const int kc = c0 + i * F_KEYS;
    mbar_wait(kv_full, i & 1);
    // K: elementwise, same layout.
    for (int e = tid; e < Tile::K / 16; e += TC_THREADS) {
      float4 hi4, lo4;
      split4(reinterpret_cast<const float4*>(Kin)[e], hi4, lo4);
      reinterpret_cast<float4*>(Khi)[e] = hi4;
      reinterpret_cast<float4*>(Klo)[e] = lo4;
    }
    // V: row d of V^T, 16-byte chunk q = 2 j + half holds keys
    // 8 j + half + {0, 2, 4, 6} (the permuted order of P's fragment).
    for (int e = tid; e < D * 8; e += TC_THREADS) {
      const int d = e % D, q = e / D;
      const int key = 8 * (q >> 1) + (q & 1);
      float4 a;
      a.x = *reinterpret_cast<const float*>(Vin + sw128_offset(key, d, F_KEYS));
      a.y = *reinterpret_cast<const float*>(Vin + sw128_offset(key + 2, d, F_KEYS));
      a.z = *reinterpret_cast<const float*>(Vin + sw128_offset(key + 4, d, F_KEYS));
      a.w = *reinterpret_cast<const float*>(Vin + sw128_offset(key + 6, d, F_KEYS));
      float4 hi4, lo4;
      split4(a, hi4, lo4);
      const int off = d * F_SLAB_ROW + ((q ^ (d & 7)) * 16);
      *reinterpret_cast<float4*>(Vthi + off) = hi4;
      *reinterpret_cast<float4*>(Vtlo + off) = lo4;
    }
    // The generic-proxy writes (and reads of the staging buffers) before
    // the tensor cores' reads and the next TMA writes.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0 && i + 1 < chunks) {
      mbar_expect(kv_full, 2 * Tile::K);
      for (int s = 0; s < Tile::SLABS; ++s) {
        tma_box(Kin + s * K_SLAB, &tk, kv_full, 32 * s, kc + F_KEYS, h, b);
        tma_box(Vin + s * K_SLAB, &tv, kv_full, 32 * s, kc + F_KEYS, h, b);
      }
    }

    if (active && kc >= my_first && kc < key_hi) {
      float s[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) s[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        wgmma_tf32_ss(s, desc_tf32(Qhi, t, Q_SLAB), desc_tf32(Klo, t, K_SLAB),
                      t);
      }
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        wgmma_tf32_ss(s, desc_tf32(Qlo, t, Q_SLAB), desc_tf32(Khi, t, K_SLAB),
                      1);
      }
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        wgmma_tf32_ss(s, desc_tf32(Qhi, t, Q_SLAB), desc_tf32(Khi, t, K_SLAB),
                      1);
      }
      wgmma_commit_wait();
      fence_regs(s);

      // The scores are already scaled (q was); masked pairs get the
      // reference's NEG_INF where the chunk is not live for every pair.
      const bool all_live = kc + F_KEYS - 1 <= q0
          && (!has_window || q_last - kc < window);
      if (!all_live) {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int r = row0 + 8 * ((e >> 1) & 1);
          const int key = kc + 8 * (e >> 2) + col0 + (e & 1);
          if (key > r || (has_window && r - key >= window)) s[e] = NEG_INF;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mt = fmaxf(mt, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        }
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m[r], mt);
        const float corr = exp2_approx((m[r] - m_new) * LOG2E);
        m[r] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2_approx((s[4 * j + 2 * r + c] - m_new) * LOG2E);
            s[4 * j + 2 * r + c] = p;
            rs += p;
          }
        }
        l[r] = l[r] * corr + rs;  // this thread's columns; summed at the end
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j + 2 * r] *= corr;
          acc[4 * j + 2 * r + 1] *= corr;
        }
      }

      // P's A fragments, hi and lo, per 8-key step.
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int order[4] = {0, 2, 1, 3};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = s[4 * j + order[r]];
          const float ah = tf32_rna(a);
          p_hi[j][r] = __float_as_uint(ah);
          p_lo[j][r] = __float_as_uint(tf32_rna(a - ah));
        }
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_tf32_rs<D>(acc, p_hi[j], desc_tf32(Vtlo, j, 0));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_tf32_rs<D>(acc, p_lo[j], desc_tf32(Vthi, j, 0));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_tf32_rs<D>(acc, p_hi[j], desc_tf32(Vthi, j, 0));
      }
      wgmma_commit_wait();
      fence_regs(acc);
      fence_regs_u(p_hi);
      fence_regs_u(p_lo);
    }
    __syncthreads();  // every product is done before the next split
  }

  if (q0 >= Sq) return;
  const long long stride = static_cast<long long>(H) * D;  // per position
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float denom = fmaxf(lt, 1e-30f);
    float* row = o + (static_cast<long long>(b) * Sq + row0 + 8 * r) * stride
               + static_cast<long long>(h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(row + 8 * j) = make_float2(
          acc[4 * j + 2 * r] / denom, acc[4 * j + 2 * r + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The (B, S, H, D) tensor at p of elements of `bytes` bytes, read in
// boxes of 128 bytes of columns (64 bf16 or 32 f32) x `rows` rows with the
// 128-byte swizzle: dims (D, S, H, B), innermost first, with strides in
// bytes.
bool tile_map(CUtensorMap* map, const void* p, CUtensorMapDataType type,
              int bytes, int B, int S, int H, int D, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(H) * D * bytes;
  const cuuint64_t strides[3] = {row, static_cast<cuuint64_t>(D) * bytes,
                                 row * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / bytes),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int H, int Sq, int Sk, int bq, int bk, int has_window,
              int window, float scale, cudaStream_t stream) {
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv;
  if (!tile_map(&tq, q, BF16, 2, B, Sq, H, D, TC_ROWS)
      || !tile_map(&tk, k, BF16, 2, B, Sk, H, D, TC_ROWS)
      || !tile_map(&tv, v, BF16, 2, B, Sk, H, D, TC_ROWS)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bytes = tc_smem_bytes<D>();
  cudaError_t rc = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int rows = TC_GROUPS * TC_ROWS;
  const dim3 grid(B * H, (Sq + rows - 1) / rows);
  flash_tc_kernel<D><<<grid, TC_THREADS, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, Sq, Sk, bq, bk,
      has_window, window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v, void* o, int B,
                int H, int Sq, int Sk, int bq, int bk, int has_window,
                int window, float scale, cudaStream_t stream) {
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap tq, tk, tv;
  if (!tile_map(&tq, q, F32, 4, B, Sq, H, D, TC_ROWS)
      || !tile_map(&tk, k, F32, 4, B, Sk, H, D, F_KEYS)
      || !tile_map(&tv, v, F32, 4, B, Sk, H, D, F_KEYS)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bytes = tf32_smem_bytes<D>();
  cudaError_t rc = cudaFuncSetAttribute(
      flash_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int rows = TC_GROUPS * TC_ROWS;
  const dim3 grid(B * H, (Sq + rows - 1) / rows);
  flash_tf32_kernel<D><<<grid, TC_THREADS, bytes, stream>>>(
      tq, tk, tv, static_cast<float*>(o), H, Sq, Sk, bq, bk, has_window,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int B, int H, int Sq, int Sk, int bq, int bk, int has_window,
           int window, float scale, cudaStream_t stream) {
  if (dtype == 0) {
    return launch_tf32<D>(q, k, v, o, B, H, Sq, Sk, bq, bk, has_window,
                          window, scale, stream);
  }
  if (dtype == 1) {
    return launch_tc<D>(q, k, v, o, B, H, Sq, Sk, bq, bk, has_window,
                        window, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  Sq % 64 == 0, bq % 64 == 0, bk % 32 ==
// 0, Sk % bk == 0, and tensors 16-byte aligned (the wrapper checks).
// window is read only when has_window is set.
int flash_attention_fwd(int dtype, int D, const void* q, const void* k,
                        const void* v, void* o, int B, int H, int Sq, int Sk,
                        int bq, int bk, int has_window, int window,
                        float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(dtype, q, k, v, o, B, H, Sq, Sk, bq, bk,
                               has_window, window, scale, s);
    case 64: return launch<64>(dtype, q, k, v, o, B, H, Sq, Sk, bq, bk,
                               has_window, window, scale, s);
    case 80: return launch<80>(dtype, q, k, v, o, B, H, Sq, Sk, bq, bk,
                               has_window, window, scale, s);
    case 128: return launch<128>(dtype, q, k, v, o, B, H, Sq, Sk, bq, bk,
                                 has_window, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
