// Hand-written Hopper (sm_90a) kernel of causal flash attention.
//
//   flash_kernel   replaces src/repro/kernels/flash_attention.py::_flash_kernel
//                  causal attention with an optional sliding window:
//                  online softmax in f32 over key chunks, masked with
//                  the reference's finite NEG_INF, output cast to the
//                  input's type.  Templated on the input type (float or
//                  bfloat16) and the head dim (32, 64, 80, 128).
//
// Layout: q (B, Sq, H, D), k and v (B, Sk, H, D), o like q, all
// contiguous; the kernel reads them with their strides, so no transposed
// copy is made.  One block of 128 threads per (batch * head, 64 query
// rows).  The query tile, scaled in f32 as the reference does, stays in
// shared memory; key/value chunks of 32 rows are staged in shared memory
// in turn (keys transposed, so a thread reads four consecutive keys as
// one float4).  Each thread owns 4 query rows x 4 keys of the score chunk
// and 4 query rows x D/8 columns of the output accumulator, in registers;
// the 8 threads of a row reduce its max and sum with warp shuffles, and
// the probabilities go through shared memory (transposed) to the P.V
// product.  Both products are f32 FMAs on the CUDA cores.
//
// What bounds it: operations.  A causal pass does 4 * D flops per live
// (query, key) pair per head; at the qwen3-8b width (S = 4096, 32 heads
// of 128) that is 137.5 GFLOP, 0.139 ms at the bf16 tensor-core peak and
// 2.05 ms at the f32 FMA peak, against 0.04 ms of bytes in bf16.  This
// simple form runs on the FMA pipes, fed from shared memory; mma.sync /
// wgmma, TMA and warp specialisation are later work (PERF.md).
//
// The key range of a query row is the reference's: tiles [lo, hi) of bk
// keys for the reference's query tile of bq rows (bq % 64 == 0, bk % 32
// == 0).  Within it a block skips a chunk that is masked for all of its
// rows when each of its rows has a live key; skipping such a chunk leaves
// every result bit unchanged (its p are exp(-1e30 - m) = 0, or the chunk
// precedes a live one whose correction exp(-1e30 - m) = 0 wipes it).
// Rows with no live key keep the reference's uniform average over the
// range, since every chunk is then computed with the finite NEG_INF.
//
// The C entry point returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BKC = 32;           // keys per chunk
constexpr int THREADS = 128;
constexpr int RPT = 4;            // query rows per thread
constexpr int CPT = 4;            // keys per thread in a chunk
constexpr int QS = BQ + 4;        // stride of the transposed query tile
constexpr int KS = BKC + 4;       // stride of the transposed key chunk
constexpr int PS = BQ + 4;        // stride of the transposed probabilities
constexpr float NEG_INF = -1e30f; // the reference's finite mask value

static_assert(BQ == 16 * RPT && BKC == 8 * CPT, "thread layout");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int smem_floats(int d) {
  return d * QS + d * KS + BKC * d + BKC * PS;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int Sq,
             int Sk, int bq, int bk, int has_window, int window,
             float scale) {
  static_assert(D % 16 == 0, "head dim");
  constexpr int CW = D / 16;      // float2 output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [D][QS]
  float* Ks = Qs + D * QS;                      // [D][KS]
  float* Vs = Ks + D * KS;                      // [BKC][D]
  float* Ps = Vs + BKC * D;                     // [BKC][PS]

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // The last query blocks have the most keys: launch them first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const long long stride = static_cast<long long>(H) * D;  // per position
  const T* qb = q + (static_cast<long long>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<long long>(b) * Sk * H + h) * D;
  const T* vb = v + (static_cast<long long>(b) * Sk * H + h) * D;
  T* ob = o + (static_cast<long long>(b) * Sq * H + h) * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    Qs[d * QS + r] = to_f32(qb[(q0 + r) * stride + d]) * scale;
  }

  // The reference's live KV tiles [lo, hi) of this query tile.
  const int qi = q0 / bq;
  const int hi = min(Sk / bk, (qi + 1) * bq / bk + (bq % bk ? 1 : 0));
  const int lo_t = qi * bq - window;
  const int lo = (has_window && lo_t > 0) ? lo_t / bk : 0;
  int key_lo = lo * bk, key_hi = hi * bk;
  const int q_last = q0 + BQ - 1;
  if (q_last < Sk && (!has_window || window >= 1)) {
    key_hi = min(key_hi, (q_last / BKC + 1) * BKC);
    const int first = q0 - window + 1;
    if (has_window && first > 0) {
      key_lo = max(key_lo, first / BKC * BKC);
    }
  }

  float m[RPT], l[RPT], acc[RPT][2 * CW];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 2 * CW; ++c) acc[i][c] = 0.f;
  }

  for (int kc = key_lo; kc < key_hi; kc += BKC) {
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < BKC * D; e += THREADS) {
      const int c = e / D, d = e % D;
      const long long off = (kc + c) * stride + d;
      Ks[d * KS + c] = to_f32(kb[off]);
      Vs[c * D + d] = to_f32(vb[off]);
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[d * QS + ty * RPT]);
      const float4 kv = *reinterpret_cast<const float4*>(&Ks[d * KS + tx * CPT]);
      const float qa[RPT] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[CPT] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty * RPT + i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = kc + tx * CPT + j;
        const bool live = kpos <= qpos && (!has_window || qpos - kpos < window);
        if (!live) s[i][j] = NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      }
      const float m_new = fmaxf(m[i], mt);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 2 * CW; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      *reinterpret_cast<float4*>(&Ps[(tx * CPT + j) * PS + ty * RPT]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKC; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(&Ps[c * PS + ty * RPT]);
      const float pa[RPT] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int w = 0; w < CW; ++w) {
        const float2 vv =
            *reinterpret_cast<const float2*>(&Vs[c * D + tx * 2 + 16 * w]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc[i][2 * w] = fmaf(pa[i], vv.x, acc[i][2 * w]);
          acc[i][2 * w + 1] = fmaf(pa[i], vv.y, acc[i][2 * w + 1]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = ob + (q0 + ty * RPT + i) * stride;
#pragma unroll
    for (int w = 0; w < CW; ++w) {
      store(row + tx * 2 + 16 * w, acc[i][2 * w] / denom);
      store(row + tx * 2 + 16 * w + 1, acc[i][2 * w + 1] / denom);
    }
  }
}

template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 int B, int H, int Sq, int Sk, int bq, int bk,
                 int has_window, int window, float scale,
                 cudaStream_t stream) {
  const int bytes = smem_floats(D) * static_cast<int>(sizeof(float));
  cudaError_t rc = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(B * H, Sq / BQ);
  flash_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Sq, Sk, bq, bk,
      has_window, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_flash_dim(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int H, int Sq, int Sk, int bq, int bk,
                     int has_window, int window, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 32: return launch_flash<T, 32>(q, k, v, o, B, H, Sq, Sk, bq, bk,
                                        has_window, window, scale, stream);
    case 64: return launch_flash<T, 64>(q, k, v, o, B, H, Sq, Sk, bq, bk,
                                        has_window, window, scale, stream);
    case 80: return launch_flash<T, 80>(q, k, v, o, B, H, Sq, Sk, bq, bk,
                                        has_window, window, scale, stream);
    case 128: return launch_flash<T, 128>(q, k, v, o, B, H, Sq, Sk, bq, bk,
                                          has_window, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  Sq % 64 == 0, bq % 64 == 0, bk % 32 ==
// 0, Sk % bk == 0 (the wrapper checks).  window is read only when
// has_window is set.
int flash_attention_fwd(int dtype, int D, const void* q, const void* k,
                        const void* v, void* o, int B, int H, int Sq, int Sk,
                        int bq, int bk, int has_window, int window,
                        float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_flash_dim<float>(D, q, k, v, o, B, H, Sq, Sk, bq, bk,
                                   has_window, window, scale, s);
  }
  if (dtype == 1) {
    return launch_flash_dim<__nv_bfloat16>(D, q, k, v, o, B, H, Sq, Sk, bq,
                                           bk, has_window, window, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
