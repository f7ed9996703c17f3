// Fused ring collectives for Hopper (sm_90a): one kernel per op and rank.
//
// Replaces the four TPU kernels of
// ray_tpu/collective/backends/pallas_backend.py:
//   ring_allreduce      <- _make_allreduce_kernel (B5): exact ring
//                          allreduce, w-1 reduce-scatter hops that combine
//                          (add, max, min, mul) + w-1 relay-gather hops;
//   ring_reducescatter  <- _make_reducescatter_kernel (B6): the reduce
//                          phase only, SUM, delta = -1 (rank r ends with
//                          reduced chunk r);
//   direct_allgather    <- _make_allgather_kernel (B7): not a ring on
//                          this card, see below;
//   ring_allreduce_q    <- _make_quantized_allreduce_kernel (B8): the
//                          EQuARX int8 ring (each reduce hop re-quantizes
//                          the partial to int8 + one f32 scale per 256
//                          values; the gather quantizes once and relays
//                          the same bytes).
// Each rank of a group launches its kernel on its own stream; in the three
// ring kernels rank r stores into rank (r+1)'s receive slots and flags,
// and acknowledges into rank (r-1)'s. The ranks may share one card or sit
// on several cards with peer access; the code is the same.
//
// Bound: bytes. A combine is one operation per element against 8-12
// bytes moved, so the least time is the bytes each rank must move through
// device memory (read its payload, write and read the w-1 + w-1 hop
// slots, write its output) at the memory rate. On one card every rank
// shares the 3.35 TB/s of HBM3; across cards the hop stores cross NVLink
// at 450 GB/s each way. Small payloads (the 16 KB decode-step class) are
// bound by the flag round trips instead: about 2(w-1) of them a call.
//
// Design.
// * No grid sync. Combining is elementwise, so CUDA block b of rank r runs
//   the whole ring schedule on slice b of every chunk and talks only to
//   block b of its neighbours. Flags are indexed by (hop, block). The
//   grid is capped by the caller at SMs / (2 * ranks on the card) blocks,
//   so that every rank's ring kernel fits on the card beside the others'
//   compute: a rank's blocks spin on flags that another rank's kernel
//   sets, and a spinning block must never keep its partner from running.
// * Peer stores and the memory model. The sender writes its slice into
//   the right neighbour's slot for the hop (16-byte stores where the
//   chunk and pointers allow, else one element a thread), __syncthreads,
//   then one thread issues __threadfence_system and a release store
//   (st.release.sys) of the call's sequence number to the neighbour's
//   flag. The receiver's thread 0 spins on an acquire load
//   (ld.acquire.sys) until the flag reaches the sequence number, then
//   __syncthreads, then the block reads the slot with ld.global.cg (L2,
//   the card's point of coherence, never a stale L1 line). System scope
//   on one card too, so that the same code holds across cards.
// * Write-once slots, as the reference (pallas_backend.py:27-36): every
//   hop writes its own slot of the receiver, and no slot is written twice
//   in one call. The slots persist across calls, so a fast left neighbour
//   could write call k+1's slot before this rank has read call k's: the
//   receiver therefore acknowledges each slot after reading it (a release
//   store of the sequence number into the sender's ack flag), and the
//   sender waits for the acknowledgement of call k before it writes the
//   slot in call k+1. A hop's data goes straight from the combine into the
//   peer's slot, so the reference's staging slots are not needed.
// * A dead or late rank aborts, it does not hang: every spin is bounded by
//   the group's timeout, read from %globaltimer from the kernel's start.
//   On expiry the block records (what it waited for, hop, block, call) in
//   the rank's status words, once, and returns; it never traps, which
//   would kill the context. The group reads the status when it next waits
//   for the rank and raises TimeoutError.
// * Rounding that matches the plain PyTorch version bit for bit: the
//   combines are __fadd_rn / __fmul_rn (never contracted into FMA), bf16
//   adds in f32 and rounds once to nearest even, int32 adds wrap, max and
//   min propagate NaN as torch.maximum / torch.minimum. The quantizer is
//   absmax / 127 and x / scale as IEEE divisions (__fdiv_rn), rintf (half
//   to even, as torch.round and jnp.round), a clamp to +-127 and a scale
//   of 1.0 for an all-zero block; dequantize-and-combine is __fmul_rn then
//   __fadd_rn. Build without --use_fast_math.
// * Instances: f32 {add, max, min, mul}, bf16 add and int32 add for the
//   allreduce; f32 add for the reduce-scatter; f32 {add, max} for the
//   quantized ring; f32 for the allgather. Any other combination returns
//   kErrUnsupported.
//
// The allgather (B7) is direct, not a ring. The TPU's ICI forced the
// reference's relay; the port's ranks are all to all (one card, or cards
// with peer access over NVLink), and a relay through hop slots moves
// 5C elements a rank at w = 2 (11C at w = 4) where the bound counts
// (w + 1)C: read x once, write w chunks. So each rank reads its x once and
// stores it straight into slot r of every rank's output, its own and the
// w - 1 peers': every element of every output is written once a call, the
// reference's write-once rule by construction, with no hop slots and no
// acknowledgements. The peers' output addresses are learned at run time
// (one host thread launches the ranks in turn, so a peer's output does not
// exist yet when a rank is launched): each rank publishes its call's
// output address in its mailbox (the address, then a release store of the
// call's sequence number), and a block acquires every peer's before it
// stores. Block b then posts a done flag, per (source rank, block), to
// each destination (release), and returns only when its own w - 1 done
// flags for block b have arrived; so neither a rank's output nor its
// mailbox is reused by its next call while a peer still writes. Rank p's
// mailbox and done flags reach the kernel through a device table of
// addresses, [2][w], made once per buffer class (no world-size limit).
// One round of flags a call replaces the relay's w - 1 round trips. Each
// thread keeps 4 16-byte loads in flight, then stores them once to each
// destination, its own first; loads and stores are streaming (evict-first),
// since no byte is touched twice. The spins are bounded as above and record
// (what, which rank, block, call) in the status words.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

enum Kind { kAllreduce = 0, kReduceScatter = 1, kQuantized = 3 };
enum DType { kF32 = 0, kBF16 = 1, kI32 = 2 };
enum Op { kAdd = 0, kMax = 1, kMin = 2, kMul = 3 };
// what a timed-out block waited for (status word 0); word 1 is the relay's
// hop for the first two and the awaited rank for the last two
enum Waited { kWaitedData = 1, kWaitedAck = 2, kWaitedMail = 3,
              kWaitedDone = 4 };

constexpr int kThreads = 512;   // exact kernels: elements per block pass
constexpr int kQThreads = 256;  // quantized: 8 warps, a quant block each
constexpr int kQuantBlock = 256;
constexpr int kGatherUnroll = 4;  // 16-byte loads in flight a thread
constexpr int kErrUnsupported = 10000;

struct RingArgs {
  const void* x;
  void* out;
  void* recv;            // own slots [hops][chunk], written by the left
  void* recv_right;      // the right neighbour's slots
  float* srecv;          // own scale slots [hops][chunk / 256] (quantized)
  float* srecv_right;
  unsigned* flags;       // own [hops][nblocks], set by the left neighbour
  unsigned* flags_right;
  unsigned* acks;        // own [hops][nblocks], set by the right neighbour
  unsigned* acks_left;
  int* status;           // own [4]: waited, hop, block, call
  long long chunk;
  int world, rank, vec;
  unsigned seq;
  unsigned long long timeout_ns;
};

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// The calling thread waits until *p reaches `want` (sequence numbers
// compare with wrap-around); false once the deadline has passed.
__device__ bool spin_until(const unsigned* p, unsigned want,
                           unsigned long long deadline) {
  while (static_cast<int>(ld_acquire(p) - want) < 0) {
    if (globaltimer() > deadline) return false;
    __nanosleep(64);
  }
  return true;
}

// Records a timed-out wait in the rank's status words, once a kernel:
// what, where (hop or rank), block, call.
__device__ void record_timeout(int* status, int waited, int where,
                               unsigned seq) {
  if (atomicCAS(status, 0, waited) == 0) {
    status[1] = where;
    status[2] = blockIdx.x;
    status[3] = static_cast<int>(seq);
  }
}

// The block waits until *p reaches `want`. False, with the rank's status
// recorded, on timeout.
__device__ bool block_wait(const RingArgs& a, const unsigned* p,
                           unsigned want, int waited, int hop,
                           unsigned long long deadline, int* ok) {
  __syncthreads();  // every thread has read the previous wait's *ok
  if (threadIdx.x == 0) {
    const int good = spin_until(p, want, deadline);
    if (!good) record_timeout(a.status, waited, hop, a.seq);
    *ok = good;
  }
  __syncthreads();
  return *ok != 0;
}

// After the block's slot traffic: publish `flag` (data is in the right
// neighbour's slot) and `ack` (this rank has read its slot), either null.
__device__ void block_post(const RingArgs& a, unsigned* flag, unsigned* ack) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    if (flag != nullptr) st_release(flag, a.seq);
    if (ack != nullptr) st_release(ack, a.seq);
  }
}

// ---------------------------------------------------------------------------
// element arithmetic
// ---------------------------------------------------------------------------

template <typename T, int OP>
struct Combine;
template <>
struct Combine<float, kAdd> {
  __device__ static float f(float a, float b) { return __fadd_rn(a, b); }
};
template <>
struct Combine<float, kMul> {
  __device__ static float f(float a, float b) { return __fmul_rn(a, b); }
};
// torch.maximum / torch.minimum: a NaN operand wins, else std::max/min.
template <>
struct Combine<float, kMax> {
  __device__ static float f(float a, float b) {
    return isnan(a) ? a : isnan(b) ? b : (a < b ? b : a);
  }
};
template <>
struct Combine<float, kMin> {
  __device__ static float f(float a, float b) {
    return isnan(a) ? a : isnan(b) ? b : (b < a ? b : a);
  }
};
template <>
struct Combine<__nv_bfloat16, kAdd> {
  __device__ static __nv_bfloat16 f(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
  }
};
template <>
struct Combine<int, kAdd> {
  __device__ static int f(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
  }
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

// A load of a receive slot: through L2 only (see the header).
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_cg(const T* p) {
  Vec<T, V> out;
  if constexpr (sizeof(T) * V == 16) {
    uint4 raw = __ldcg(reinterpret_cast<const uint4*>(p));
    memcpy(&out, &raw, 16);
  } else if constexpr (sizeof(T) * V == 4) {
    unsigned raw = __ldcg(reinterpret_cast<const unsigned*>(p));
    memcpy(&out, &raw, 4);
  } else {
    static_assert(sizeof(T) * V == 2, "2-, 4- or 16-byte accesses");
    unsigned short raw = __ldcg(reinterpret_cast<const unsigned short*>(p));
    memcpy(&out, &raw, 2);
  }
  return out;
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Vec<T, V>& v) {
  *reinterpret_cast<Vec<T, V>*>(p) = v;
}

// One hop over the block's slice [lo, hi) of a chunk: v = cmb(recv, x)
// (or recv alone, or x alone, where the other is null), stored to the
// right neighbour's slot and to the output where those are not null.
template <typename T, int OP, int V>
__device__ void hop_loop(const T* recv, const T* x, T* peer, T* out,
                         long long lo, long long hi) {
  for (long long i = lo + static_cast<long long>(threadIdx.x) * V; i < hi;
       i += static_cast<long long>(blockDim.x) * V) {
    Vec<T, V> v;
    if (recv != nullptr && x != nullptr) {
      const Vec<T, V> r = load_cg<T, V>(recv + i);
      const Vec<T, V> xv = load<T, V>(x + i);
#pragma unroll
      for (int j = 0; j < V; ++j) v.v[j] = Combine<T, OP>::f(r.v[j], xv.v[j]);
    } else if (recv != nullptr) {
      v = load_cg<T, V>(recv + i);
    } else {
      v = load<T, V>(x + i);
    }
    if (peer != nullptr) store<T, V>(peer + i, v);
    if (out != nullptr) store<T, V>(out + i, v);
  }
}

template <typename T, int OP>
__device__ void hop(const RingArgs& a, const T* recv, const T* x, T* peer,
                    T* out, long long lo, long long hi) {
  constexpr int kVec = 16 / sizeof(T);
  if (a.vec)
    hop_loop<T, OP, kVec>(recv, x, peer, out, lo, hi);
  else
    hop_loop<T, OP, 1>(recv, x, peer, out, lo, hi);
}

// The block's slice of a chunk; a multiple of 8 elements wide, so that
// every slice starts on a 16-byte boundary when the chunk does.
__device__ __forceinline__ void slice(long long chunk, long long* lo,
                                      long long* hi) {
  const long long per = ((chunk + gridDim.x - 1) / gridDim.x + 7) / 8 * 8;
  *lo = per * blockIdx.x;
  *hi = min(chunk, *lo + per);
}

__device__ __forceinline__ int mod(int a, int w) { return ((a % w) + w) % w; }

// Slot h of a [hops][n] buffer, and the (hop, block) flag of a
// [hops][nblocks] one.
template <typename T>
__device__ __forceinline__ T* slot(void* base, int h, long long n) {
  return static_cast<T*>(base) + h * n;
}
__device__ __forceinline__ unsigned* flag(unsigned* base, int h) {
  return base + h * gridDim.x + blockIdx.x;
}

// ---------------------------------------------------------------------------
// B5: exact ring allreduce (delta = 0: rank r reduces chunk (r+1) mod w)
// ---------------------------------------------------------------------------

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads) ring_allreduce(RingArgs a) {
  __shared__ int ok;
  const int w = a.world, r = a.rank;
  const long long C = a.chunk;
  long long lo, hi;
  slice(C, &lo, &hi);
  if (lo >= hi) return;  // the same on every rank
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  if (w == 1) {
    hop<T, OP>(a, nullptr, x, nullptr, out, lo, hi);
    return;
  }
  const unsigned long long deadline = globaltimer() + a.timeout_ns;
  // hop 0 sends the rank's own chunk
  if (!block_wait(a, flag(a.acks, 0), a.seq - 1, kWaitedAck, 0, deadline,
                  &ok))
    return;
  hop<T, OP>(a, nullptr, x + r * C, slot<T>(a.recv_right, 0, C), nullptr, lo,
             hi);
  block_post(a, flag(a.flags_right, 0), nullptr);
  // reduce-scatter: hop s combines the received partial with chunk r - s
  // and sends it on; the last one is the reduced chunk r + 1, which is
  // also the first gather hop
  for (int s = 1; s < w; ++s) {
    if (!block_wait(a, flag(a.flags, s - 1), a.seq, kWaitedData, s - 1,
                    deadline, &ok) ||
        !block_wait(a, flag(a.acks, s), a.seq - 1, kWaitedAck, s, deadline,
                    &ok))
      return;
    T* o = s == w - 1 ? out + mod(r + 1, w) * C : nullptr;
    hop<T, OP>(a, slot<T>(a.recv, s - 1, C), x + mod(r - s, w) * C,
               slot<T>(a.recv_right, s, C), o, lo, hi);
    block_post(a, flag(a.flags_right, s), flag(a.acks_left, s - 1));
  }
  // relay-gather: gather hop s delivers reduced chunk r - s + 1 and relays
  // it, except the last
  for (int s = 1; s < w; ++s) {
    const int in = w - 2 + s;
    const bool last = s == w - 1;
    if (!block_wait(a, flag(a.flags, in), a.seq, kWaitedData, in, deadline,
                    &ok) ||
        (!last && !block_wait(a, flag(a.acks, in + 1), a.seq - 1, kWaitedAck,
                              in + 1, deadline, &ok)))
      return;
    hop<T, OP>(a, slot<T>(a.recv, in, C), nullptr,
               last ? nullptr : slot<T>(a.recv_right, in + 1, C),
               out + mod(r - s + 1, w) * C, lo, hi);
    block_post(a, last ? nullptr : flag(a.flags_right, in + 1),
               flag(a.acks_left, in));
  }
}

// ---------------------------------------------------------------------------
// B6: reduce-scatter, SUM, delta = -1 (rank r ends with reduced chunk r)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) ring_reducescatter(RingArgs a) {
  __shared__ int ok;
  const int w = a.world, r = a.rank;
  const long long C = a.chunk;
  long long lo, hi;
  slice(C, &lo, &hi);
  if (lo >= hi) return;
  const float* x = static_cast<const float*>(a.x);
  float* out = static_cast<float*>(a.out);
  if (w == 1) {
    hop<float, kAdd>(a, nullptr, x, nullptr, out, lo, hi);
    return;
  }
  const unsigned long long deadline = globaltimer() + a.timeout_ns;
  if (!block_wait(a, flag(a.acks, 0), a.seq - 1, kWaitedAck, 0, deadline,
                  &ok))
    return;
  hop<float, kAdd>(a, nullptr, x + mod(r - 1, w) * C,
                   slot<float>(a.recv_right, 0, C), nullptr, lo, hi);
  block_post(a, flag(a.flags_right, 0), nullptr);
  for (int s = 1; s < w; ++s) {
    const bool last = s == w - 1;
    if (!block_wait(a, flag(a.flags, s - 1), a.seq, kWaitedData, s - 1,
                    deadline, &ok) ||
        (!last && !block_wait(a, flag(a.acks, s), a.seq - 1, kWaitedAck, s,
                              deadline, &ok)))
      return;
    hop<float, kAdd>(a, slot<float>(a.recv, s - 1, C),
                     x + mod(r - 1 - s, w) * C,
                     last ? nullptr : slot<float>(a.recv_right, s, C),
                     last ? out : nullptr, lo, hi);
    block_post(a, last ? nullptr : flag(a.flags_right, s),
               flag(a.acks_left, s - 1));
  }
}

// ---------------------------------------------------------------------------
// B7: direct allgather; out is [w][chunk] (see the header)
// ---------------------------------------------------------------------------

struct GatherArgs {
  const float* x;
  float* out;
  // [2][world] addresses: rank p's mailbox (u64 output address, then the
  // u32 sequence number of the call that published it), then rank p's
  // done flags ([world][nblocks] u32, set by the source ranks)
  const unsigned long long* peers;
  int* status;
  long long chunk;
  int world, rank, vec;
  unsigned seq;
  unsigned long long timeout_ns;
};

__device__ __forceinline__ unsigned long long ld_relaxed_u64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Streaming (evict-first) accesses: the allgather touches each byte once,
// so it keeps none of them in L2.
template <int V>
__device__ __forceinline__ Vec<float, V> load_cs(const float* p) {
  Vec<float, V> out;
  if constexpr (V == 4) {
    const float4 raw = __ldcs(reinterpret_cast<const float4*>(p));
    memcpy(&out, &raw, 16);
  } else {
    static_assert(V == 1, "4- or 16-byte accesses");
    out.v[0] = __ldcs(p);
  }
  return out;
}

template <int V>
__device__ __forceinline__ void store_cs(float* p, const Vec<float, V>& v) {
  if constexpr (V == 4) {
    float4 raw;
    memcpy(&raw, &v, 16);
    __stcs(reinterpret_cast<float4*>(p), raw);
  } else {
    static_assert(V == 1, "4- or 16-byte accesses");
    __stcs(p, v.v[0]);
  }
}

// The block's slice [lo, hi) of x into slot `off` of every destination:
// U loads of V floats in flight a thread, then one store a destination.
template <int V, int U>
__device__ void scatter(const float* x, const unsigned long long* dst,
                        int w, int first, long long off, long long lo,
                        long long hi) {
  const long long step = static_cast<long long>(blockDim.x) * V;
  for (long long i0 = lo + static_cast<long long>(threadIdx.x) * V; i0 < hi;
       i0 += step * U) {
    Vec<float, V> v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u * step < hi) v[u] = load_cs<V>(x + i0 + u * step);
    for (int k = 0, d = first; k < w; ++k, d = d + 1 == w ? 0 : d + 1) {
      float* o = reinterpret_cast<float*>(dst[d]) + off;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u * step < hi) store_cs<V>(o + i0 + u * step, v[u]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) direct_allgather(GatherArgs a) {
  extern __shared__ unsigned long long dst[];  // [w] output addresses
  const int w = a.world, r = a.rank;
  const long long C = a.chunk;
  long long lo, hi;
  slice(C, &lo, &hi);
  if (lo >= hi) return;  // the same on every rank
  const unsigned long long deadline = globaltimer() + a.timeout_ns;
  const unsigned long long* const* mail =
      reinterpret_cast<const unsigned long long* const*>(a.peers);
  if (threadIdx.x == 0) {  // publish this call's output address
    unsigned long long* own = const_cast<unsigned long long*>(mail[r]);
    own[0] = reinterpret_cast<unsigned long long>(a.out);
    st_release(reinterpret_cast<unsigned*>(own + 1), a.seq);
  }
  // every peer's output address: thread p waits for rank p's mailbox
  int good = 1, aligned = 1;
  for (int p = threadIdx.x; p < w; p += blockDim.x) {
    unsigned long long addr = reinterpret_cast<unsigned long long>(a.out);
    if (p != r) {
      if (good && spin_until(reinterpret_cast<const unsigned*>(mail[p] + 1),
                             a.seq, deadline)) {
        addr = ld_relaxed_u64(mail[p]);
      } else {
        if (good) record_timeout(a.status, kWaitedMail, p, a.seq);
        good = 0;
      }
    }
    dst[p] = addr;
    aligned &= addr % 16 == 0;
  }
  if (!__syncthreads_and(good)) return;
  const long long off = static_cast<long long>(r) * C;
  if (__syncthreads_and(aligned) && a.vec)
    scatter<4, kGatherUnroll>(a.x, dst, w, r, off, lo, hi);
  else
    scatter<1, kGatherUnroll>(a.x, dst, w, r, off, lo, hi);
  __syncthreads();
  // done flags: this block's slice has landed in rank p's output
  unsigned* const* done = reinterpret_cast<unsigned* const*>(a.peers + w);
  for (int p = threadIdx.x; p < w; p += blockDim.x) {
    if (p == r) continue;
    __threadfence_system();
    st_release(done[p] + r * gridDim.x + blockIdx.x, a.seq);
  }
  // return once every peer's block b has landed its slice here
  for (int p = threadIdx.x; p < w; p += blockDim.x) {
    if (p == r) continue;
    if (!spin_until(done[r] + p * gridDim.x + blockIdx.x, a.seq, deadline)) {
      record_timeout(a.status, kWaitedDone, p, a.seq);
      break;
    }
  }
}

// ---------------------------------------------------------------------------
// B8: the quantized ring. A warp owns one 256-value quant block at a time,
// 8 consecutive values a lane; the block's slice is whole quant blocks.
// ---------------------------------------------------------------------------

struct Quant {
  uint2 q;      // 8 int8 values of this lane
  float scale;  // the quant block's scale (every lane holds it)
};

__device__ __forceinline__ Quant quantize8(const float (&v)[8]) {
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  Quant out;
  out.scale = m > 0.f ? __fdiv_rn(m, 127.0f) : 1.0f;
  signed char q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float t = rintf(__fdiv_rn(v[j], out.scale));
    q[j] = static_cast<signed char>(
        static_cast<int>(fminf(fmaxf(t, -127.f), 127.f)));
  }
  memcpy(&out.q, q, 8);
  return out;
}

__device__ __forceinline__ void dequantize8(const Quant& qt, float (&v)[8]) {
  signed char q[8];
  memcpy(q, &qt.q, 8);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = __fmul_rn(static_cast<float>(q[j]), qt.scale);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

struct QSlots {
  signed char* q;  // [hops][chunk]
  float* s;        // [hops][chunk / 256]
};

__device__ __forceinline__ Quant load_quant(const QSlots& in, int h,
                                            long long chunk, long long qb,
                                            int lane) {
  Quant qt;
  qt.q = __ldcg(reinterpret_cast<const uint2*>(
      in.q + h * chunk + qb * kQuantBlock + lane * 8));
  qt.scale = __ldcg(in.s + h * (chunk / kQuantBlock) + qb);
  return qt;
}

__device__ __forceinline__ void store_quant(const QSlots& out, int h,
                                            long long chunk, long long qb,
                                            int lane, const Quant& qt) {
  *reinterpret_cast<uint2*>(out.q + h * chunk + qb * kQuantBlock + lane * 8) =
      qt.q;
  if (lane == 0) out.s[h * (chunk / kQuantBlock) + qb] = qt.scale;
}

template <int OP>
__global__ void __launch_bounds__(kQThreads) ring_allreduce_q(RingArgs a) {
  __shared__ int ok;
  const int w = a.world, r = a.rank;
  const long long C = a.chunk, nqb = C / kQuantBlock;
  const long long per = (nqb + gridDim.x - 1) / gridDim.x;
  const long long qlo = per * blockIdx.x, qhi = min(nqb, qlo + per);
  if (qlo >= qhi) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kWarps = kQThreads / 32;
  const float* x = static_cast<const float*>(a.x);
  float* out = static_cast<float*>(a.out);
  const QSlots own{static_cast<signed char*>(a.recv), a.srecv};
  const QSlots right{static_cast<signed char*>(a.recv_right), a.srecv_right};
  float v[8], xv[8];
  if (w == 1) {  // the reference quantizes and dequantizes its one chunk
    for (long long qb = qlo + warp; qb < qhi; qb += kWarps) {
      const long long e = qb * kQuantBlock + lane * 8;
      load8(x + e, v);
      dequantize8(quantize8(v), v);
      store8(out + e, v);
    }
    return;
  }
  const unsigned long long deadline = globaltimer() + a.timeout_ns;
  if (!block_wait(a, flag(a.acks, 0), a.seq - 1, kWaitedAck, 0, deadline,
                  &ok))
    return;
  for (long long qb = qlo + warp; qb < qhi; qb += kWarps) {
    load8(x + r * C + qb * kQuantBlock + lane * 8, v);
    store_quant(right, 0, C, qb, lane, quantize8(v));
  }
  block_post(a, flag(a.flags_right, 0), nullptr);
  for (int s = 1; s < w; ++s) {
    if (!block_wait(a, flag(a.flags, s - 1), a.seq, kWaitedData, s - 1,
                    deadline, &ok) ||
        !block_wait(a, flag(a.acks, s), a.seq - 1, kWaitedAck, s, deadline,
                    &ok))
      return;
    for (long long qb = qlo + warp; qb < qhi; qb += kWarps) {
      const long long e = qb * kQuantBlock + lane * 8;
      dequantize8(load_quant(own, s - 1, C, qb, lane), v);
      load8(x + mod(r - s, w) * C + e, xv);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = Combine<float, OP>::f(v[j], xv[j]);
      const Quant qt = quantize8(v);
      store_quant(right, s, C, qb, lane, qt);
      if (s == w - 1) {
        dequantize8(qt, v);
        store8(out + mod(r + 1, w) * C + e, v);
      }
    }
    block_post(a, flag(a.flags_right, s), flag(a.acks_left, s - 1));
  }
  for (int s = 1; s < w; ++s) {
    const int in = w - 2 + s;
    const bool last = s == w - 1;
    if (!block_wait(a, flag(a.flags, in), a.seq, kWaitedData, in, deadline,
                    &ok) ||
        (!last && !block_wait(a, flag(a.acks, in + 1), a.seq - 1, kWaitedAck,
                              in + 1, deadline, &ok)))
      return;
    for (long long qb = qlo + warp; qb < qhi; qb += kWarps) {
      const Quant qt = load_quant(own, in, C, qb, lane);
      if (!last) store_quant(right, in + 1, C, qb, lane, qt);
      dequantize8(qt, v);
      store8(out + mod(r - s + 1, w) * C + qb * kQuantBlock + lane * 8, v);
    }
    block_post(a, last ? nullptr : flag(a.flags_right, in + 1),
               flag(a.acks_left, in));
  }
}

template <typename K>
int launch(K kernel, int threads, int nblocks, const RingArgs& a,
           cudaStream_t s) {
  kernel<<<nblocks, threads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One ring collective of one rank, on `stream`; does not synchronise.
// kind: 0 allreduce, 1 reduce-scatter, 3 quantized allreduce. dtype:
// 0 f32, 1 bf16, 2 int32. op: 0 add, 1 max, 2 min, 3 mul. chunk: elements
// of one of the w chunks of x. The slot, flag and ack buffers are the
// group's, laid out as RingArgs says; every rank of a call passes the
// same chunk, nblocks and seq. Returns the cudaError_t of the launch, or
// kErrUnsupported for an instance that is not built.
int ring_launch(int kind, int dtype, int op, const void* x, void* out,
                void* recv, void* recv_right, float* srecv,
                float* srecv_right, unsigned* flags, unsigned* flags_right,
                unsigned* acks, unsigned* acks_left, int* status,
                long long chunk, int world, int rank, int nblocks,
                unsigned seq, unsigned long long timeout_ns, void* stream) {
  if (chunk <= 0 || world < 1 || rank < 0 || rank >= world || nblocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  RingArgs a{x,     out,         recv, recv_right,  srecv,
             srecv_right, flags, flags_right, acks, acks_left,
             status, chunk, world, rank, 0, seq, timeout_ns};
  const int elt = dtype == kBF16 ? 2 : 4;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(recv) |
                         reinterpret_cast<uintptr_t>(recv_right);
  a.vec = (ptrs % 16 == 0) && (chunk % (16 / elt) == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kAllreduce) {
    if (dtype == kF32 && op == kAdd)
      return launch(ring_allreduce<float, kAdd>, kThreads, nblocks, a, s);
    if (dtype == kF32 && op == kMax)
      return launch(ring_allreduce<float, kMax>, kThreads, nblocks, a, s);
    if (dtype == kF32 && op == kMin)
      return launch(ring_allreduce<float, kMin>, kThreads, nblocks, a, s);
    if (dtype == kF32 && op == kMul)
      return launch(ring_allreduce<float, kMul>, kThreads, nblocks, a, s);
    if (dtype == kBF16 && op == kAdd)
      return launch(ring_allreduce<__nv_bfloat16, kAdd>, kThreads, nblocks,
                    a, s);
    if (dtype == kI32 && op == kAdd)
      return launch(ring_allreduce<int, kAdd>, kThreads, nblocks, a, s);
    return kErrUnsupported;
  }
  if (dtype != kF32) return kErrUnsupported;
  if (kind == kReduceScatter && op == kAdd)
    return launch(ring_reducescatter, kThreads, nblocks, a, s);
  if (kind == kQuantized) {
    if (chunk % kQuantBlock != 0 || !a.vec)
      return static_cast<int>(cudaErrorInvalidValue);
    if (op == kAdd)
      return launch(ring_allreduce_q<kAdd>, kQThreads, nblocks, a, s);
    if (op == kMax)
      return launch(ring_allreduce_q<kMax>, kQThreads, nblocks, a, s);
  }
  return kErrUnsupported;
}

// One direct allgather (B7) of one rank, on `stream`; does not
// synchronise. x: the rank's f32 [chunk]; out: its [world][chunk]; peers:
// the group's device table of [2][world] addresses (every rank's mailbox,
// then every rank's [world][nblocks] done flags), as GatherArgs says.
// Every rank of a call passes the same chunk, nblocks and seq. Returns the
// cudaError_t of the launch.
int allgather_launch(const float* x, float* out,
                     const unsigned long long* peers, int* status,
                     long long chunk, int world, int rank, int nblocks,
                     unsigned seq, unsigned long long timeout_ns,
                     void* stream) {
  if (chunk <= 0 || world < 1 || rank < 0 || rank >= world || nblocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  GatherArgs a{x, out, peers, status, chunk, world, rank, 0, seq,
               timeout_ns};
  a.vec = ((reinterpret_cast<uintptr_t>(x) |
            reinterpret_cast<uintptr_t>(out)) % 16 == 0) && chunk % 4 == 0;
  const size_t smem = sizeof(unsigned long long) * world;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        direct_allgather, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  direct_allgather<<<nblocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Lets the current device's kernels store into `peer`'s memory (ranks on
// several cards). Returns the cudaError_t; an already enabled pair is 0.
int ring_enable_peer_access(int peer) {
  cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // reset the last error; the pair is usable
    return 0;
  }
  return static_cast<int>(err);
}

const char* ring_error_string(int code) {
  if (code == kErrUnsupported) return "instance not built";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
