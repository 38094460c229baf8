// Hand-written Hopper (sm_90a) kernels of the windowed strategy: the
// paper's serial walks (Lemire & Mula, Algorithms 2-4).
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
// loop whose next position depends on the window just read.  The walk
// stays serial (one block walks the whole buffer); what bounds it is the
// latency of one step, times the steps.  So the block splits a step's work
// so that as little as possible sits on the loop-carried chain:
//
//   warp 0, the producer: fills a ring of STAGES shared-memory stages with
//           1-D bulk copies (cp.async.bulk, TMA) ahead of the walk, one
//           full/empty mbarrier pair a stage.  The copies start and end on
//           16-byte boundaries; the elements of an unaligned head or tail
//           (a view's data_ptr(), an n that is no multiple of 16 bytes)
//           come by plain loads, so nothing outside x[0, n) is read.
//   warp 1, the walker: carries only the position from step to step.
//           Every operand comes from the ring; each lane reads its own
//           elements.  UTF-8: the window key is one ballot of the lanes'
//           end bits, the table word (core/tables.py::window_packed) gives
//           the bytes consumed in one extract (bits 21-24), and the ASCII
//           test is one vote over 64 bytes (a run of ASCII blocks goes
//           through a loop of two loads and that vote).  UTF-16: the step
//           (8 units, or 7 when unit 7 is a high half that unit 6 does not
//           pair with) is one ballot of the high halves.  The rest of a
//           step (UTF-8: the ballot of the supplementary characters, read
//           off the lead and the next byte; UTF-16: the low halves and the
//           three bit-planes of the per-unit byte counts) and its record
//           are made during the next step, in its loads' shadow.  Once a
//           batch of BATCH records, the walker counts them: each record's
//           units (the characters plus the supplementary ones; the bytes
//           of the units consumed) by popcounts, their offsets by a
//           ballot-and-popcount scan over bit-planes, and the error flag;
//           the count q and the flag are its other loop-carried state.
//   warp 2, the emitter: takes the batches in order, from a queue of
//           BATCHES, decodes or encodes each record's window from the
//           ring and stores it; it releases the ring's stages the records
//           have passed.  A batch of clean records goes lane-parallel
//           (each lane its own record; the warp copies ASCII blocks),
//           any other record by record (emit_utf8, emit_utf16).
//
// Semantics are those of the reference's walk, on malformed input too:
// int32 lanes, elements at and past n read as 0, arithmetic shifts and
// wrapping sums; every store of the reference's window (64, 12, 2 or 24
// elements at min(q, cap - width), where dynamic_update_slice clamps it)
// lands as the reference's does.  A record is clean when its window is
// not clamped and the units it stores are exactly the units it advances
// (q..q + advance), the rest of the window zeros: then the emitter stores
// only those units and needs no order against the other clean records,
// whose ranges are disjoint; the zeros it leaves out are stored over by
// the records after it, or lie at and past the final count, which the
// kernel zeroes.  Any other record (an int32 value past 0xFFFF pushing q
// past p into the clamp, a lone surrogate whose stored bytes and recount
// disagree, the last, partly filled register) stores its whole window,
// zeros included, ordered between __syncwarp()s, so a later store wins as
// in the reference; its batch goes record by record.  The UTF-8 tail
// runs on the walker after the emitter has finished.  The output arrives
// zeroed; the kernel zeroes what the stores left past the final count,
// so the buffer is 0 from count on, as the reference masks it.
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

// The input ring (core/windowed.py::STAGE_BYTES, RING_STAGES): a stage
// holds 4096 bytes, so 4096 uint8, 2048 uint16 or 1024 int32 elements.
constexpr int STAGE_BYTES = 4096;
constexpr int STAGES = 4;                // a power of two
constexpr int RING_BYTES = STAGE_BYTES * STAGES;
// The step queue between the walker and the emitter.
constexpr int BATCH = 32;                // records a batch
constexpr int BATCHES = 4;               // a power of two
constexpr int LAST = 1 << 8;             // a batch count flag: the walk ends
constexpr int ASCII_KEY = -1;            // a UTF-8 record key: an ASCII block
constexpr int THREADS = 96;              // producer, walker, emitter
constexpr int SLEEP_NS = 128;            // the producer's, emitter's polls

static_assert(RING_BYTES % 16 == 0 && (STAGES & (STAGES - 1)) == 0, "ring");
// The emitter releases a stage once a batch it has emitted has passed it,
// and the walker may hold one batch back: the ring must span a batch's
// reach (BATCH steps of at most BLOCK elements), the walker's 64 elements
// ahead and the stage being filled, at the widest element.
static_assert(RING_BYTES / 4 >= BATCH * BLOCK + BLOCK + STAGE_BYTES / 4,
              "the ring cannot hold a batch ahead of the walker");

// UTF-8 sequence length by lead byte >> 3 (core/tables.py::LEAD_LENGTH_32).
__constant__ int kLeadLength[32] = {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0,
                                    0, 0, 2, 2, 2, 2, 3, 3, 4, 0};

struct __align__(128) Shared {
  unsigned char ring[RING_BYTES];        // stage s at s * STAGE_BYTES
  unsigned long long full[STAGES];       // a stage's copy has landed
  unsigned long long empty[STAGES];      // the emitter has passed a stage
  unsigned long long bfull[BATCHES];     // the walker has filled a batch
  unsigned long long bempty[BATCHES];    // the emitter has emitted a batch
  int4 rec[BATCHES][BATCH];              // (p, q, key or take, e or advance)
  int count[BATCHES];                    // records, | LAST on the last batch
};

// int32 arithmetic that wraps, as the reference's does.
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wshl(int a, int s) {
  return static_cast<int>(static_cast<unsigned>(a) << s);
}

// ---------------------------------------------------------------------------
// Shared-memory barriers and the bulk copy (PTX).

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A loop-invariant shared-memory address, computed once: the compiler
// would otherwise rederive it (an S2R of the CTA's id) inside the walk,
// on the loop-carried chain.
__device__ __forceinline__ uint32_t smem_base(const void* p) {
  uint32_t a;
  asm volatile("mov.b32 %0, %1;" : "=r"(a) : "r"(smem_addr(p)));
  return a;
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_test(unsigned long long* bar,
                                          uint32_t phase) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(phase) : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          uint32_t phase) {
  while (!mbar_test(bar, phase)) {
  }
}

// The producer's and the emitter's waits: they sleep between polls, so
// that their polling leaves the shared-memory pipe to the walker.
__device__ __forceinline__ void mbar_wait_sleep(unsigned long long* bar,
                                                uint32_t phase) {
  while (!mbar_test(bar, phase)) __nanosleep(SLEEP_NS);
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Loads and stores at a shared-memory address.  The walker and the
// emitter address the ring, the table and the queue this way: through a
// generic pointer the compiler re-derives the shared window's base (an
// S2R of the CTA's id) on every access, on the loop-carried chain.
template <typename T>
__device__ __forceinline__ int ld_shared(uint32_t addr);
template <>
__device__ __forceinline__ int ld_shared<uint8_t>(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(addr));
  return static_cast<int>(v);
}
template <>
__device__ __forceinline__ int ld_shared<uint16_t>(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=r"(v) : "r"(addr));
  return static_cast<int>(v);
}
template <>
__device__ __forceinline__ int ld_shared<int32_t>(uint32_t addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ int4 ld_shared_v4(uint32_t addr) {
  int4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, int v) {
  asm volatile("st.shared.b32 [%0], %1;" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, int4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned; completes on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// The ring.

// Where x lies against the ring: element i sits at byte (head + i * size)
// of a virtual stream that starts at x's 16-byte aligned base, and stage k
// holds that stream's bytes [k * STAGE_BYTES, (k + 1) * STAGE_BYTES).
template <typename T>
struct Ring {
  static constexpr int ELEMS = RING_BYTES / static_cast<int>(sizeof(T));
  static constexpr int STAGE = STAGE_BYTES / static_cast<int>(sizeof(T));
  uint32_t base;    // the ring's shared-memory address
  int n, off;       // off: elements between the aligned base and x

  __device__ Ring(const Shared& s, const T* x, int n_)
      : base(smem_base(s.ring)), n(n_),
        off(static_cast<int>((reinterpret_cast<uintptr_t>(x) & 15) /
                             sizeof(T))) {}

  // The element at virtual index v (x[v - off]), whatever it holds.
  __device__ __forceinline__ int slot(int v) const {
    return ld_shared<T>(base +
                        static_cast<uint32_t>(v & (ELEMS - 1)) * sizeof(T));
  }

  // Element i of the masked input (0 at and past n); i must be resident.
  __device__ __forceinline__ int operator()(int i) const {
    const int v = slot(i + off);
    return i < n ? v : 0;
  }

  // Stages holding x[0, n).
  __device__ int stages() const {
    return n > 0 ? static_cast<int>(
                       (static_cast<long long>(off) + n + STAGE - 1) / STAGE)
                 : 0;
  }

  // Elements x[0, result) are resident once stages [0, k) have landed
  // (none before the first: with n = 0 no stage is ever copied).
  __device__ int resident(int k) const {
    const long long e = static_cast<long long>(k) * STAGE - off;
    return static_cast<int>(e < 0 ? 0 : e < n ? e : n);
  }
};

// Warp 0: copy the stages of x[0, n) into the ring, each once the emitter
// has released the stage that held its slot before, then wait for the
// copies in flight to land.  The walker waits for every stage (the last
// before its tail), so the loop runs to its end.
template <typename T>
__device__ void produce(Shared& s, const T* x, const Ring<T>& ring,
                        int lane) {
  constexpr long long E = sizeof(T);
  const char* base = reinterpret_cast<const char*>(
      reinterpret_cast<uintptr_t>(x) & ~static_cast<uintptr_t>(15));
  const long long head = static_cast<long long>(ring.off) * E;
  const long long end = head + static_cast<long long>(ring.n) * E;
  const int stages = ring.stages();
  for (int k = 0; k < stages; ++k) {
    const int slot = k & (STAGES - 1);
    if (k >= STAGES)
      mbar_wait_sleep(&s.empty[slot], ((k / STAGES) - 1) & 1);
    // The stage's bytes of x: [lo, hi); the bulk copy takes the 16-byte
    // aligned [a, b) inside, the lanes the elements either side.
    const long long k0 = static_cast<long long>(k) * STAGE_BYTES;
    const long long lo = k0 > head ? k0 : head;
    const long long hi = k0 + STAGE_BYTES < end ? k0 + STAGE_BYTES : end;
    const long long a = (lo + 15) & ~15ll, b = hi & ~15ll;
    const bool bulk = a < b;
    const int m1 = static_cast<int>(((bulk ? a : hi) - lo) / E);
    const int m2 = bulk ? static_cast<int>((hi - b) / E) : 0;
    unsigned char* stage = s.ring + slot * STAGE_BYTES;
    if (lane < m1 + m2) {
      const long long at = lane < m1 ? lo + lane * E : b + (lane - m1) * E;
      *reinterpret_cast<T*>(stage + (at - k0)) =
          *reinterpret_cast<const T*>(base + at);
    }
    __syncwarp();
    if (lane == 0) {
      if (bulk) {
        mbar_expect(&s.full[slot], static_cast<uint32_t>(b - a));
        bulk_copy(stage + (a - k0), base + a, static_cast<uint32_t>(b - a),
                  &s.full[slot]);
      } else {
        mbar_arrive(&s.full[slot]);
      }
    }
  }
  for (int k = stages > STAGES ? stages - STAGES : 0; k < stages; ++k)
    mbar_wait(&s.full[k & (STAGES - 1)], (k / STAGES) & 1);
}

// The walker's side of the ring and the queue; a step reads W elements.
// The walks call need(p) before a step's loads and record(rec, valid)
// once a step; when the batch is full() they fill in its records' counts
// (account_utf8/16 at batch_addr()) and publish() it.
template <typename T, int W>
struct Walk {
  Shared& s;
  const Ring<T>& ring;
  int lane;
  int stages_in = 0;             // stages waited for
  int lim = -1;                  // a step at p <= lim needs no wait
  int batch = 0, count = 0;      // the batch being filled, its records
  uint32_t recs;                 // the queue's shared-memory address

  __device__ Walk(Shared& s_, const Ring<T>& r, int lane_)
      : s(s_), ring(r), lane(lane_), recs(smem_base(&s_.rec[0][0])) {}

  // Make x[p, min(p + W, n)) resident, waiting for the next stages if
  // need be; returns the last position whose step needs no wait, so the
  // walk checks once a stage, not once a step.
  __device__ __forceinline__ int need(int p) {
    if (p > lim) wait_for(p + W);
    return lim;
  }

  __device__ void wait_for(int upto) {
    const int want = upto < ring.n ? upto : ring.n;
    int ready = ring.resident(stages_in);
    while (ready < want) {
      mbar_wait(&s.full[stages_in & (STAGES - 1)], (stages_in / STAGES) & 1);
      ready = ring.resident(++stages_in);
    }
    lim = ready >= ring.n ? INT32_MAX : ready - W;
  }

  // Queue one step's record (lane 0 stores it) when valid; no branch.
  __device__ __forceinline__ void record(int4 rec, bool valid) {
    if (lane == 0 && valid)
      st_shared_v4(recs + 16 * ((batch & (BATCHES - 1)) * BATCH + count),
                   rec);
    count += valid;
  }

  __device__ __forceinline__ bool full() const { return count == BATCH; }
  __device__ __forceinline__ int size() const { return count; }
  // The batch being filled, at this shared-memory address.
  __device__ __forceinline__ uint32_t batch_addr() const {
    return recs + 16 * BATCH * (batch & (BATCHES - 1));
  }

  // Hand the batch to the emitter (the lanes' stores to it ordered
  // before lane 0's arrival), then wait until the next batch's slot is
  // free.
  __device__ void publish(int last = 0) {
    __syncwarp();
    if (lane == 0) {
      s.count[batch & (BATCHES - 1)] = count | last;
      mbar_arrive(&s.bfull[batch & (BATCHES - 1)]);
    }
    ++batch;
    count = 0;
    if (!last && batch >= BATCHES)
      mbar_wait(&s.bempty[batch & (BATCHES - 1)],
                ((batch / BATCHES) - 1) & 1);
  }
};

// Warp 2's loop: emit each batch in order (emit(recs, records): the
// batch's records at shared address recs), then release the stages its
// last record has passed.
template <typename T, typename Emit>
__device__ void emit_batches(Shared& s, const Ring<T>& ring, int lane,
                             Emit emit) {
  int released = 0;
  for (int batch = 0;; ++batch) {
    const int slot = batch & (BATCHES - 1);
    mbar_wait_sleep(&s.bfull[slot], (batch / BATCHES) & 1);
    const int count = s.count[slot];
    const int records = count & (LAST - 1);
    const uint32_t recs = smem_addr(&s.rec[slot][0]);
    emit(recs, records);
    __syncwarp();   // every lane's loads and stores of the batch are done
    if (lane == 0) {
      if (records > 0) {
        const long long passed =
            static_cast<long long>(s.rec[slot][records - 1].x) + ring.off;
        while (static_cast<long long>(released + 1) * Ring<T>::STAGE <=
               passed) {
          mbar_arrive(&s.empty[released & (STAGES - 1)]);
          ++released;
        }
      }
      mbar_arrive(&s.bempty[slot]);
    }
    if (count & LAST) break;
  }
}

__device__ void init_shared(Shared& s, int tid) {
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i]);
      mbar_init(&s.empty[i]);
    }
    for (int i = 0; i < BATCHES; ++i) {
      mbar_init(&s.bfull[i]);
      mbar_init(&s.bempty[i]);
    }
    mbar_fence_init();
  }
}

// Where a walker's loop ended: the position, the count, the error flag.
struct Walked {
  int p, q;
  bool err;
};

__device__ __forceinline__ int final_status(const int* status0, int validate,
                                            bool err) {
  if (!validate) return STATUS_OK;
  const int s0 = *status0;
  return s0 >= 0 ? s0 : (err ? 0 : STATUS_OK);
}

// ---------------------------------------------------------------------------
// UTF-8 -> UTF-16 (Algorithms 2 and 3).

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

// One UTF-8 record's stores: an ASCII block's 64 elements, or the window's
// 12 units (lane l decodes the character that starts at byte l).
template <typename T>
__device__ __forceinline__ void emit_utf8(const Ring<T>& in, int4 rec,
                                          int cap, int* __restrict__ out,
                                          int lane) {
  const int p = rec.x, q = rec.y, key = rec.z;
  if (key == ASCII_KEY) {
    const int s = min(q, cap - BLOCK);
    const int v0 = in(p + lane), v1 = in(p + 32 + lane);
    if (s != q) __syncwarp();
    out[s + lane] = v0;
    out[s + 32 + lane] = v1;
    if (s != q) __syncwarp();
    return;
  }
  const unsigned e = static_cast<unsigned>(rec.w);
  const int consumed = (e >> 21) & 15;
  // Character starts among the bytes consumed: byte 0, and each byte after
  // an end.
  const unsigned starts = ((static_cast<unsigned>(key) << 1) | 1) &
                          ((1u << consumed) - 1);
  const bool live = (starts >> lane) & 1;
  const int len = live ? __ffs(static_cast<unsigned>(key) >> lane) : 0;
  const int cp = decode_char(len, in(p + lane), in(p + lane + 1),
                             in(p + lane + 2), in(p + lane + 3));
  const bool supp = live && cp >= 0x10000;
  const unsigned smask = __ballot_sync(FULL, supp);
  const unsigned lt = (1u << lane) - 1;
  const int off = __popc(starts & lt) + __popc(smask & lt);
  const int units = __popc(starts) + __popc(smask);
  const int s = min(q, cap - WINDOW);
  if (s != q) __syncwarp();
  if (live) {
    const int v = wadd(cp, -0x10000);
    out[s + off] = supp ? 0xD800 + (v >> 10) : cp;
    if (supp) out[s + off + 1] = 0xDC00 + (v & 0x3FF);
  }
  if (s != q) {
    if (lane >= units && lane < WINDOW) out[s + lane] = 0;
    __syncwarp();
  }
}

// The exclusive prefix sum over the lanes of v (0 <= v < 2^bits), and its
// total: a ballot and two popcounts a bit-plane, no shuffle.
template <int BITS>
__device__ __forceinline__ int plane_scan(int v, int lane, int* total) {
  const unsigned lt = (1u << lane) - 1;
  int off = 0, sum = 0;
#pragma unroll
  for (int b = 0; b < BITS; ++b) {
    const unsigned m = __ballot_sync(FULL, (v >> b) & 1);
    off += __popc(m & lt) << b;
    sum += __popc(m) << b;
  }
  *total = sum;
  return off;
}

// A full UTF-8 batch's accounting, once every 32 steps: record k (lane k)
// holds (p, the supplementary starts' mask, key or ASCII_KEY, table
// word); its units are the characters plus the supplementary ones among
// the bytes consumed (64 for an ASCII block), its count q the units
// before it.  Fills in each record's q, advances q, flags a key with no
// character.
__device__ __forceinline__ void account_utf8(uint32_t recs, int count,
                                             int lane, int& q, bool& err) {
  __syncwarp();                  // lane 0's records are in place
  int units = 0;
  bool bad = false;
  if (lane < count) {
    const int4 r = ld_shared_v4(recs + 16 * lane);
    const unsigned e = static_cast<unsigned>(r.w);
    const int consumed = (e >> 21) & 15;
    units = r.z == ASCII_KEY
                ? BLOCK
                : int(e & 7) + __popc(static_cast<unsigned>(r.y) &
                                      ((1u << consumed) - 1));
    bad = r.z != ASCII_KEY && (e & 7) == 0;
  }
  int total;
  const int off = plane_scan<7>(units, lane, &total);
  if (lane < count) st_shared_b32(recs + 16 * lane + 4, q + off);
  q += total;
  err |= __any_sync(FULL, bad);
}

// The UTF-8 walker's loop: the windows and ASCII blocks while 12 bytes
// are left, queue as in Walk.  The loads are raw: the window's 12 bytes
// lie below n, byte p + 12 lies past it only when p + 12 == n (its end
// bit is then set by hand), and the block's 64 bytes count only when
// p + 64 <= n.
//
// Only the position is carried from step to step: a step's loads, the
// key's ballot, the table's load and the bytes consumed.  A step's
// record is stored during the next step, in the shadow of its loads;
// the counts and the error flag follow once a batch (account_utf8).
template <typename T, typename Queue>
__device__ __forceinline__ Walked walk_utf8(const Ring<T>& in,
                                            uint32_t tab, int n,
                                            int lane, Queue& queue) {
  int p = 0, q = 0;
  bool err = false;
  const int l0 = lane + in.off;   // lane l reads bytes p + l, p + 1 + l
  const bool window_lane = lane < WINDOW;          // and p + 32 + l
  // The last step's record, stored during the next step, in the shadow
  // of that step's loads: (p, supplementary starts, key or ASCII_KEY,
  // table word).
  int4 held = make_int4(-1, 0, 0, 0);
  while (p <= n - WINDOW) {
    const int stop = min(queue.need(p), n - WINDOW);
    bool ascii;
    do {
      const int nx = in.slot(p + 1 + l0);
      const int v0 = in.slot(p + l0), v1 = in.slot(p + 32 + l0);
      queue.record(held, held.x >= 0);
      // End-of-character bitset of the window: byte l ends a character
      // iff byte l + 1 is no continuation byte or lies past the end.
      const unsigned key =
          (__ballot_sync(FULL, (nx & 0xC0) != 0x80) |
           (p == n - WINDOW ? 1u << (WINDOW - 1) : 0u)) & (KEYS - 1);
      const unsigned e = ld_shared<int32_t>(tab + 4 * key);
      ascii = __all_sync(FULL, v0 < 0x80 && v1 < 0x80) && p <= n - BLOCK;
      // Lane l starting a supplementary character: of one element past
      // 0xFFFF (int32 input), or of four bytes whose code point passes
      // 0xFFFF, which bits 0-2 of the lead and 4-5 of the next byte say
      // (bitwise, not short-circuit: no branch).
      const unsigned kl = key >> lane;
      const bool start = window_lane & ((((key << 1) | 1) >> lane) & 1);
      const bool one = (kl & 1) & (v0 >= 0x10000);
      const bool four = ((kl & 15) == 8) & (((v0 & 7) | (nx & 0x30)) != 0);
      const unsigned smask = __ballot_sync(FULL, start & (one | four));
      held = make_int4(p, int(smask), ascii ? ASCII_KEY : int(key), int(e));
      if (ascii)
        p += BLOCK;
      else                                       // always make progress
        p = max(p + int((e >> 21) & 15), p + 1);
    } while (p <= stop && !queue.full() && !ascii);
    // After an ASCII block, the run of ASCII blocks that follows: two
    // loads and a vote a block.  (The step above takes a block with no
    // branch, so a window never waits for this test, but a block there
    // waits for the table's load as a window does.)
    if (ascii) {
      const int last = min(stop, n - BLOCK);
      while (p <= last && !queue.full()) {
        const int a0 = in.slot(p + l0), a1 = in.slot(p + 32 + l0);
        if (!__all_sync(FULL, a0 < 0x80 && a1 < 0x80)) break;
        queue.record(held, true);
        held = make_int4(p, 0, ASCII_KEY, 0);
        p += BLOCK;
      }
    }
    if (queue.full()) {
      account_utf8(queue.batch_addr(), BATCH, lane, q, err);
      queue.publish();
    }
  }
  queue.record(held, held.x >= 0);
  account_utf8(queue.batch_addr(), queue.size(), lane, q, err);
  return {p, q, err};
}

// One UTF-8 batch: the walker's records at shared address recs.  When
// every record's window lies below the capacity, each record stores its
// units alone and the records' ranges are disjoint: the warp copies the
// ASCII blocks, and each lane decodes its own window's characters.
// Otherwise the records go one by one, in order (emit_utf8).
template <typename T>
__device__ __forceinline__ void emit_utf8_batch(const Ring<T>& in,
                                                uint32_t recs, int records,
                                                int cap,
                                                int* __restrict__ out,
                                                int lane) {
  const bool live = lane < records;
  const int4 mine =
      live ? ld_shared_v4(recs + 16 * lane) : make_int4(0, 0, ASCII_KEY, 0);
  if (!__all_sync(FULL, !live || mine.y <= cap - BLOCK)) {
    for (int k = 0; k < records; ++k)
      emit_utf8(in, ld_shared_v4(recs + 16 * k), cap, out, lane);
    return;
  }
  for (unsigned m = __ballot_sync(FULL, live && mine.z == ASCII_KEY); m;
       m &= m - 1) {
    const int k = __ffs(m) - 1;
    const int p = __shfl_sync(FULL, mine.x, k);
    const int q = __shfl_sync(FULL, mine.y, k);
    out[q + lane] = in(p + lane);
    out[q + 32 + lane] = in(p + 32 + lane);
  }
  if (live && mine.z != ASCII_KEY) {
    const unsigned key = static_cast<unsigned>(mine.z);
    const unsigned e = static_cast<unsigned>(mine.w);
    unsigned starts = ((key << 1) | 1) & ((1u << ((e >> 21) & 15)) - 1);
    int at = mine.y;
    while (starts) {
      const int j = __ffs(starts) - 1;
      starts &= starts - 1;
      const int b = mine.x + j;
      const int cp = decode_char(__ffs(key >> j), in(b), in(b + 1),
                                 in(b + 2), in(b + 3));
      if (cp >= 0x10000) {
        const int v = wadd(cp, -0x10000);
        out[at] = 0xD800 + (v >> 10);
        out[at + 1] = 0xDC00 + (v & 0x3FF);
        at += 2;
      } else {
        out[at++] = cp;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    windowed_utf8_kernel(const T* __restrict__ x, int n, int cap,
                         const int* __restrict__ status0, int validate,
                         const unsigned* __restrict__ table,
                         int* __restrict__ out, int* __restrict__ fin) {
  __shared__ Shared s;
  __shared__ unsigned tab[KEYS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  init_shared(s, tid);
  for (int i = tid; i < KEYS; i += THREADS) tab[i] = table[i];
  __syncthreads();
  const Ring<T> in(s, x, n);
  if (warp == 0) {
    produce(s, x, in, lane);
  } else if (warp == 2) {
    emit_batches(s, in, lane, [&](uint32_t recs, int records) {
      emit_utf8_batch(in, recs, records, cap, out, lane);
    });
  }
  Walked w{0, 0, false};
  if (warp == 1) {
    Walk<T, BLOCK> walk(s, in, lane);
    w = walk_utf8(in, smem_base(tab), n, lane, walk);
    walk.wait_for(n);
    walk.publish(LAST);
  }
  __syncthreads();   // the emitter's stores are done
  if (warp != 1) return;
  int p = w.p, q = w.q;
  bool err = w.err;
  // The conventional tail (< 12 bytes), one character a step on lane 0.
  if (lane == 0) {
    while (p < n) {
      const int w0 = in(p);
      const int idx = w0 >> 3;       // jnp.take: wraps negatives, fills
      int len = idx >= -32 && idx < 32 ? kLeadLength[idx & 31] : INT32_MIN;
      err |= len == 0;
      len = min(max(len, 1), n - p);
      const int cp =
          decode_char(len, w0, in(p + 1), in(p + 2), in(p + 3));
      const bool supp = cp >= 0x10000;
      const int v = wadd(cp, -0x10000);
      const int st = min(q, cap - 2);
      out[st] = supp ? 0xD800 + (v >> 10) : cp;
      out[st + 1] = supp ? 0xDC00 + (v & 0x3FF) : 0;
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

// A lane's byte offset, or the register's total, from the three bit-planes
// of per-unit byte counts 0..4.
__device__ __forceinline__ int planes(unsigned b0, unsigned b1, unsigned b2,
                                      unsigned mask) {
  return __popc(b0 & mask) + 2 * __popc(b1 & mask) + 4 * __popc(b2 & mask);
}

// One register's stores: its 24 bytes (the characters' bytes, those past
// 24 dropped, zeros after them); lanes 0-7 hold the units.
template <typename T>
__device__ __forceinline__ void emit_utf16(const Ring<T>& in, int4 rec,
                                           int cap, int* __restrict__ out,
                                           int lane) {
  const int p = rec.x, q = rec.y, take = rec.z, advance = rec.w;
  const bool reg_lane = lane < REGISTER;
  const int r = reg_lane ? in(p + lane) : 0;
  const bool hi = reg_lane && (r >> 10) == 0x36;
  const bool lo = reg_lane && (r >> 10) == 0x37;
  int L, cp = r;
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
    const bool prv_hi = __shfl_up_sync(FULL, hi, 1) && lane > 0;
    const bool lead = lane < take && !(lo && prv_hi);
    const int pair = wadd(wadd(0x10000, wshl(wadd(r, -0xD800), 10)),
                          wadd(nxt, -0xDC00));
    cp = hi ? pair : r;
    L = lead ? 1 + (cp >= 0x80) + (cp >= 0x800) + (cp >= 0x10000) : 0;
  }
  const unsigned b0 = __ballot_sync(FULL, L & 1);
  const unsigned b1 = __ballot_sync(FULL, L & 2);
  const unsigned b2 = __ballot_sync(FULL, L & 4);
  const int start = planes(b0, b1, b2, (1u << lane) - 1);
  const int total = planes(b0, b1, b2, FULL);
  const int s = min(q, cap - REG_BYTES);
  const bool clean = s == q && total == advance && total <= REG_BYTES;
  if (!clean) __syncwarp();
  for (int j = 0; j < L && start + j < REG_BYTES; ++j)
    out[s + start + j] = utf8_byte(cp, L, j);
  if (!clean) {
    if (lane >= total && lane < REG_BYTES) out[s + lane] = 0;
    __syncwarp();
  }
}

// A full UTF-16 batch's accounting, once every 32 steps: record k (lane
// k) holds (p, the per-unit byte counts' bit-planes b0 | b1 << 8 |
// b2 << 16, take | high halves << 8 | low halves << 16).  Its units
// consumed are take clamped to n - p; its bytes advanced the bit-planes'
// popcounts over them (a high half 4, a low half 0, else 1-3), its count
// q the bytes before it.  Rewrites each record as (p, q, take,
// advance), advances q, flags Algorithm 4's surrogate errors: a high
// half not followed by a low one before the last unit taken, a low half
// not preceded by a high one, a leading high half last.
__device__ __forceinline__ void account_utf16(uint32_t recs, int count,
                                              int lane, int n, int& q,
                                              bool& err) {
  __syncwarp();                  // lane 0's records are in place
  int advance = 0, p = 0, take = 0;
  bool bad = false;
  if (lane < count) {
    const int4 r = ld_shared_v4(recs + 16 * lane);
    const unsigned pl = static_cast<unsigned>(r.y);
    const unsigned marks = static_cast<unsigned>(r.z);
    p = r.x;
    take = marks & 0xFF;
    const unsigned his = (marks >> 8) & 0xFF, los = (marks >> 16) & 0xFF;
    const int k = min(take, n - p);
    advance = planes(pl & 0xFF, (pl >> 8) & 0xFF, (pl >> 16) & 0xFF,
                     (1u << k) - 1);
    const unsigned live = (1u << take) - 1;
    const unsigned lead = live & ~(los & (his << 1));
    bad = ((his & ~(los >> 1) & (live >> 1)) | (los & ~(his << 1) & live) |
           (his & lead & (1u << (take - 1)))) != 0;
  }
  int total;
  const int off = plane_scan<6>(advance, lane, &total);
  if (lane < count)
    st_shared_v4(recs + 16 * lane, make_int4(p, q + off, take, advance));
  q += total;
  err |= __any_sync(FULL, bad);
}

// The UTF-16 walker's loop over the registers, queue as in Walk: whole
// registers with raw loads, then the last, partly filled one, whose units
// past n read as 0.  Only the position is carried from step to step: a
// step's load, the high halves' ballot and the units taken (8, or 7 when
// unit 7 is a high half that unit 6 does not pair with).  The step's
// other ballots (its low halves, the bit-planes of its per-unit byte
// counts) go into its record, stored during the next step; the counts
// and the error flag follow once a batch (account_utf16).
template <typename T, typename Queue>
__device__ __forceinline__ Walked walk_utf16(const Ring<T>& in, int n,
                                             int lane, Queue& queue) {
  int p = 0, q = 0;
  bool err = false;
  const int l0 = lane + in.off;
  const bool reg_lane = lane < REGISTER;
  // The last step: (p, -, take | high halves << 8, -) and its lane's
  // unit.  Its other ballots and its record are made during the next
  // step, in the shadow of that step's load.
  int4 held = make_int4(-1, 0, 0, 0);
  int held_r = 0;
  const auto finish = [&]() {
    const bool hi = reg_lane & ((held_r >> 10) == 0x36);
    const bool lo = reg_lane & ((held_r >> 10) == 0x37);
    const unsigned los = __ballot_sync(FULL, lo);
    const int per = hi ? 4 : lo ? 0 : 1 + (held_r >= 0x80) + (held_r >= 0x800);
    const unsigned b0 = __ballot_sync(FULL, reg_lane & ((per & 1) != 0));
    const unsigned b1 = __ballot_sync(FULL, reg_lane & ((per & 2) != 0));
    const unsigned b2 = __ballot_sync(FULL, per & 4);
    queue.record(make_int4(held.x, int(b0 | b1 << 8 | b2 << 16),
                           int(static_cast<unsigned>(held.z) | los << 16),
                           0),
                 held.x >= 0);
  };
  // The chain: the high halves' ballot and the units taken.
  const auto step = [&](int r) {
    const unsigned his =
        __ballot_sync(FULL, reg_lane & ((r >> 10) == 0x36));
    const int take = (his & 0xC0) == 0x80 ? REGISTER - 1 : REGISTER;
    held = make_int4(p, 0, int(take | his << 8), 0);
    held_r = r;
    return take;
  };
  while (p <= n - REGISTER) {
    const int stop = min(queue.need(p), n - REGISTER);
    do {
      const int r = in.slot(p + l0);
      finish();
      p += step(r);
    } while (p <= stop && !queue.full());
    if (queue.full()) {
      account_utf16(queue.batch_addr(), BATCH, lane, n, q, err);
      queue.publish();
    }
  }
  if (p < n) {
    queue.need(p);
    const int r = reg_lane ? in(p + lane) : 0;
    finish();
    if (queue.full()) {
      account_utf16(queue.batch_addr(), BATCH, lane, n, q, err);
      queue.publish();
    }
    p += min(step(r), n - p);
  }
  finish();
  account_utf16(queue.batch_addr(), queue.size(), lane, n, q, err);
  return {p, q, err};
}

// One UTF-16 batch: when every record is clean (its 24-byte window below
// the capacity, and the bytes it encodes exactly the bytes the walker
// advanced), each lane encodes its own register and stores those bytes;
// otherwise the records go one by one, in order (emit_utf16).
template <typename T>
__device__ __forceinline__ void emit_utf16_batch(const Ring<T>& in,
                                                 uint32_t recs, int records,
                                                 int cap,
                                                 int* __restrict__ out,
                                                 int lane) {
  const bool live = lane < records;
  const int4 mine =
      live ? ld_shared_v4(recs + 16 * lane) : make_int4(0, 0, REGISTER, 0);
  int r[REGISTER], cp[REGISTER], L[REGISTER];
  bool surr = false;
#pragma unroll
  for (int i = 0; i < REGISTER; ++i) {
    r[i] = live ? in(mine.x + i) : 0;
    surr |= (r[i] >> 11) == 0x1B;      // a high or a low half
  }
  int total = 0;
#pragma unroll
  for (int i = 0; i < REGISTER; ++i) {
    if (!surr) {
      // Cases 0-2: the unit's own 1-3 bytes.
      cp[i] = r[i];
      L[i] = 1 + (r[i] >= 0x80) + (r[i] >= 0x800);
    } else {
      // Case 3: fold pairs, emit from each character's first unit.
      const bool hi = (r[i] >> 10) == 0x36, lo = (r[i] >> 10) == 0x37;
      const int nxt = i + 1 < REGISTER ? r[i + 1] : 0;
      const bool prv_hi = i > 0 && (r[i - 1] >> 10) == 0x36;
      const bool lead = i < mine.z && !(lo && prv_hi);
      const int pair = wadd(wadd(0x10000, wshl(wadd(r[i], -0xD800), 10)),
                            wadd(nxt, -0xDC00));
      cp[i] = hi ? pair : r[i];
      L[i] = lead ? 1 + (cp[i] >= 0x80) + (cp[i] >= 0x800) +
                        (cp[i] >= 0x10000)
                  : 0;
    }
    total += L[i];
  }
  const bool clean = !live || (mine.y <= cap - REG_BYTES &&
                               total == mine.w && total <= REG_BYTES);
  if (!__all_sync(FULL, clean)) {
    for (int k = 0; k < records; ++k)
      emit_utf16(in, ld_shared_v4(recs + 16 * k), cap, out, lane);
    return;
  }
  if (live) {
    int at = mine.y;
#pragma unroll
    for (int i = 0; i < REGISTER; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < L[i]) out[at + j] = utf8_byte(cp[i], L[i], j);
      at += L[i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    windowed_utf16_kernel(const T* __restrict__ x, int n, int cap,
                          const int* __restrict__ status0, int validate,
                          int* __restrict__ out, int* __restrict__ fin) {
  __shared__ Shared s;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  init_shared(s, tid);
  __syncthreads();
  const Ring<T> in(s, x, n);
  if (warp == 0) {
    produce(s, x, in, lane);
  } else if (warp == 2) {
    emit_batches(s, in, lane, [&](uint32_t recs, int records) {
      emit_utf16_batch(in, recs, records, cap, out, lane);
    });
  }
  Walked w{0, 0, false};
  if (warp == 1) {
    Walk<T, REGISTER> walk(s, in, lane);
    w = walk_utf16(in, n, lane, walk);
    walk.publish(LAST);
  }
  __syncthreads();   // the emitter's stores are done
  if (warp != 1) return;
  const int q = w.q;
  // The stores reach at most 24 elements past the final count.
  for (int i = q + lane; i < min(q + REG_BYTES, cap); i += 32) out[i] = 0;
  if (lane == 0) {
    fin[0] = q;
    fin[1] = final_status(status0, validate, w.err);
  }
}

template <typename T>
int launch_utf8(const void* x, int n, int cap, const int* status0,
                int validate, const unsigned* table, int* out, int* fin,
                cudaStream_t stream) {
  windowed_utf8_kernel<T><<<1, THREADS, 0, stream>>>(
      static_cast<const T*>(x), n, cap, status0, validate, table, out, fin);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_utf16(const void* x, int n, int cap, const int* status0,
                 int validate, int* out, int* fin, cudaStream_t stream) {
  windowed_utf16_kernel<T><<<1, THREADS, 0, stream>>>(
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
