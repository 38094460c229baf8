// Latency microbenchmarks of the windowed walker's loop-carried chain
// (built and run by tools/step_latency.py on the card).
//
// Each chase_* kernel runs one warp through CHAIN dependent repetitions
// of one link of the chain, between two clock64() reads: a shared-memory
// load whose address is the last load's value (LDS), a predicate made
// from a value and balloted (LOP3/ISETP + VOTE), a popcount of a masked
// value (LOP3 + POPC), an integer multiply-add (IMAD), a shuffle (SHFL).
// The walker_* kernels run the walkers' own loops (walk_utf8, walk_utf16
// of windowed.cu, included below) over an input already resident in the
// shared-memory ring, with nothing to wait for and no emitter: the
// cycles a step of the walker alone, its records and batch accounting
// included.  spin gives the SM clock under a
// one-warp load.

#include "../src/repro_torch/kernels/csrc/windowed.cu"

namespace {

constexpr int CHAIN = 512;

__device__ __forceinline__ void finish(long long* out, long long t0,
                                       long long t1, int keep) {
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = keep;
  }
}

__global__ void chase_empty(long long* out, int seed) {
  const long long t0 = clock64();
  const long long t1 = clock64();
  finish(out, t0, t1, seed);
}

__global__ void chase_lds(long long* out, int seed) {
  __shared__ int sm[1024];
  for (int i = threadIdx.x; i < 1024; i += 32) sm[i] = i;
  __syncwarp();
  int v = (threadIdx.x + seed) & 1023;
  const long long t0 = clock64();
#pragma unroll 16
  for (int k = 0; k < CHAIN; ++k) v = sm[v];
  const long long t1 = clock64();
  finish(out, t0, t1, v);
}

__global__ void chase_ballot(long long* out, int seed) {
  unsigned v = 0x5a5a5a5au ^ seed;
  const long long t0 = clock64();
#pragma unroll 16
  for (int k = 0; k < CHAIN; ++k)
    v = __ballot_sync(FULL, (v >> threadIdx.x) & 1);
  const long long t1 = clock64();
  finish(out, t0, t1, int(v));
}

__global__ void chase_popc(long long* out, int seed) {
  unsigned v = 0x5a5a5a5au ^ seed ^ threadIdx.x;
#pragma unroll 1
  for (int w = 0; w < 2; ++w) v = v * 3 + 1;
  const long long t0 = clock64();
#pragma unroll 16
  for (int k = 0; k < CHAIN; ++k) v = __popc(v & 0xfffu) << (v & 7);
  const long long t1 = clock64();
  finish(out, t0, t1, int(v));
}

__global__ void chase_imad(long long* out, int seed) {
  int v = seed + threadIdx.x;
  const long long t0 = clock64();
#pragma unroll 16
  for (int k = 0; k < CHAIN; ++k) v = v * v + seed;
  const long long t1 = clock64();
  finish(out, t0, t1, v);
}

__global__ void chase_shfl(long long* out, int seed) {
  int v = seed + threadIdx.x;
  const long long t0 = clock64();
#pragma unroll 16
  for (int k = 0; k < CHAIN; ++k) v = __shfl_sync(FULL, v, v & 31);
  const long long t1 = clock64();
  finish(out, t0, t1, v);
}

// The walks' queue with no emitter behind it: the input is resident, a
// full batch is accounted and then dropped.
struct LocalQueue {
  uint32_t recs;
  int count = 0, steps = 0;
  __device__ int need(int) const { return INT32_MAX; }
  __device__ void record(int4 rec, bool valid) {
    if (threadIdx.x == 0 && valid) st_shared_v4(recs + 16 * count, rec);
    count += valid;
    steps += valid;
  }
  __device__ bool full() const { return count == BATCH; }
  __device__ int size() const { return count; }
  __device__ uint32_t batch_addr() const { return recs; }
  __device__ void publish() {
    __syncwarp();
    count = 0;
  }
};

// The input (at most a ring of elements) copied into the ring, then the
// walker's loop over it: out = (cycles, steps, p, q, err).
template <typename T>
__device__ Ring<T> fill_ring(Shared& s, const T* x, int n) {
  const Ring<T> in(s, x, n);
  T* slots = reinterpret_cast<T*>(s.ring);
  for (int i = threadIdx.x; i < n; i += 32)
    slots[(i + in.off) & (Ring<T>::ELEMS - 1)] = x[i];
  __syncwarp();
  return in;
}

template <typename T>
__global__ void walker_utf8(const T* x, int n, const unsigned* table,
                            long long* out) {
  __shared__ Shared s;
  __shared__ unsigned tab[KEYS];
  for (int i = threadIdx.x; i < KEYS; i += 32) tab[i] = table[i];
  const Ring<T> in = fill_ring(s, x, n);
  LocalQueue queue{smem_base(&s.rec[0][0])};
  const long long t0 = clock64();
  const Walked w = walk_utf8(in, smem_base(tab), n, threadIdx.x, queue);
  const long long t1 = clock64();
  const int steps = queue.steps;
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = steps;
    out[2] = w.p;
    out[3] = w.q;
    out[4] = w.err;
  }
}

template <typename T>
__global__ void walker_utf16(const T* x, int n, long long* out) {
  __shared__ Shared s;
  const Ring<T> in = fill_ring(s, x, n);
  LocalQueue queue{smem_base(&s.rec[0][0])};
  const long long t0 = clock64();
  const Walked w = walk_utf16(in, n, threadIdx.x, queue);
  const long long t1 = clock64();
  const int steps = queue.steps;
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = steps;
    out[2] = w.p;
    out[3] = w.q;
    out[4] = w.err;
  }
}

// One warp spinning for `cycles` SM cycles: timed by events on the host,
// the SM clock under a one-warp load.
__global__ void spin(long long cycles, long long* out) {
  const long long t0 = clock64();
  long long t = t0;
  while (t - t0 < cycles) t = clock64();
  if (threadIdx.x == 0) out[0] = t - t0;
}

}  // namespace

extern "C" {

int step_latency_spin(long long cycles, long long* out) {
  spin<<<1, 32>>>(cycles, out);
  return static_cast<int>(cudaGetLastError());
}

int step_latency_chain() { return CHAIN; }

// which: 0 empty, 1 LDS, 2 ballot, 3 popc, 4 imad, 5 shfl.
int step_latency_chase(int which, long long* out) {
  switch (which) {
    case 0: chase_empty<<<1, 32>>>(out, 7); break;
    case 1: chase_lds<<<1, 32>>>(out, 7); break;
    case 2: chase_ballot<<<1, 32>>>(out, 7); break;
    case 3: chase_popc<<<1, 32>>>(out, 7); break;
    case 4: chase_imad<<<1, 32>>>(out, 7); break;
    case 5: chase_shfl<<<1, 32>>>(out, 7); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaDeviceSynchronize());
}

// direction 8: UTF-8 (uint8), 16: UTF-16 (uint16); n at most a ring.
int step_latency_walker(int direction, const void* x, int n,
                        const unsigned* table, long long* out) {
  if (direction == 8)
    walker_utf8<uint8_t><<<1, 32>>>(static_cast<const uint8_t*>(x), n,
                                     table, out);
  else
    walker_utf16<uint16_t><<<1, 32>>>(static_cast<const uint16_t*>(x), n,
                                       out);
  return static_cast<int>(cudaDeviceSynchronize());
}

}  // extern "C"
