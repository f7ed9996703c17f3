// Fused collectives for Hopper (sm_90a): one kernel per op and rank.
//
// Replaces the four TPU kernels of
// ray_tpu/collective/backends/pallas_backend.py:
//   direct_reduce<ALL>  <- _make_allreduce_kernel (B5): exact allreduce
//                          (add, max, min, mul), in the ring's combine
//                          order, not a ring on this card; see below;
//   direct_reduce<RS>   <- _make_reducescatter_kernel (B6): SUM, rank r
//                          ends with reduced chunk r (the ring's
//                          delta = -1), likewise direct;
//   direct_allgather    <- _make_allgather_kernel (B7): direct;
//   ring_allreduce_q    <- _make_quantized_allreduce_kernel (B8): the
//                          EQuARX int8 ring (each reduce hop re-quantizes
//                          the partial to int8 + one f32 scale per 256
//                          values; the gather quantizes once and relays
//                          the same bytes).
// Each rank of a group launches its kernel on its own stream. The ranks
// may share one card or sit on several cards with peer access; the code is
// the same.
//
// Bound: bytes. A combine is one operation per element against 8-12
// bytes moved, so the least time is the bytes the ranks must move through
// device memory (each input read once, each output written once) at the
// memory rate. On one card every rank shares the 3.35 TB/s of HBM3; across
// cards the peers' reads and stores cross NVLink at 450 GB/s each way.
// Small payloads (the 16 KB decode-step class) are bound by the host's
// launches and the flag round trips instead.
//
// The direct kernels (B5, B6, B7). The TPU's ICI forced the reference's
// rings; the port's ranks reach each other all to all (one card, or cards
// with peer access over NVLink), and a ring through hop slots moves every
// hop's partial through memory twice: B5's relay moved about twice the
// bytes the bound counts at w = 2. A reduction is elementwise, and the ring
// fixes only the order in which each chunk combines the ranks' values, so
// rank r computes chunk r itself, in that order, from every rank's input:
//   B5: chunk r = x_r[r], then x_{r+1}[r], ..., x_{r+w-1}[r] (mod w), each
//       folded as acc = cmb(acc, x_p[r]); the result is stored into chunk r
//       of every rank's output, its own first. Every input element is read
//       once and every output element written once.
//   B6: chunk r = x_{r+1}[r], then x_{r+2}[r], ..., x_r[r]; the result into
//       rank r's own output only.
//   B7: x_r into slot r of every rank's output.
// This is the ring's rounding bit for bit: the combines are __fadd_rn /
// __fmul_rn (never contracted into FMA); bf16 combines in f32 and rounds
// to bf16 after every combine, as torch rounds each a + b of bf16 tensors;
// int32 adds wrap; max and min propagate NaN as torch.maximum /
// torch.minimum. Build without --use_fast_math.
//
// The direct protocol. One host thread launches the ranks in turn, so a
// peer's buffers are not known when a rank is launched: each rank publishes
// its call's input and output addresses in its mailbox (the two addresses,
// then a release store (st.release.sys) of the call's sequence number),
// and every block acquires (ld.acquire.sys) every peer's before it moves
// data. Block b of rank r works on slice b of its chunk and talks only to
// block b of the peers (no grid sync): it then posts a done flag, per
// (source rank, block), to each peer (release), and returns only once its
// own w - 1 done flags for block b have arrived. So when a rank's kernel
// ends, every peer has finished reading its input and writing its output,
// and neither those buffers nor its mailbox are still in use when the
// caller reuses them or the next call publishes. Rank p's mailbox and done
// flags reach the kernel through a device table of addresses, [2][w], made
// once per buffer class (no world-size limit). Each thread keeps 4 16-byte
// loads in flight a source (loads through L2 only, ld.global.cg, never a
// stale L1 line of a peer's buffer), then stores each result once to each
// destination, streaming (evict-first): no byte is touched twice. The grid
// is capped by the caller at SMs / (2 * ranks on the card) blocks, so that
// every rank's kernel fits on the card beside the others' work: a rank's
// blocks spin on flags that another rank's kernel sets, and a spinning
// block must never keep its partner from running.
//
// The quantized ring (B8) keeps the reference's hops, since every hop
// re-quantizes its partial: block b of every rank runs the ring schedule
// on slice b of every chunk. The sender writes its slice into the right
// neighbour's slot for the hop, __syncthreads, then one thread issues
// __threadfence_system and a release store of the call's sequence number
// to the neighbour's flag; the receiver's thread 0 spins on an acquire
// load until the flag reaches the sequence number, then __syncthreads,
// then the block reads the slot with ld.global.cg. Write-once slots, as
// the reference (pallas_backend.py:27-36): every hop writes its own slot of
// the receiver. The slots persist across calls, so the receiver
// acknowledges each slot after reading it, and the sender waits for call
// k's acknowledgement before it writes the slot in call k + 1. The
// quantizer is absmax / 127 and x / scale as IEEE divisions (__fdiv_rn),
// rintf (half to even, as torch.round and jnp.round), a clamp to +-127 and
// a scale of 1.0 for an all-zero block; dequantize-and-combine is __fmul_rn
// then __fadd_rn.
//
// A dead or late rank aborts, it does not hang: every spin is bounded by
// the group's timeout, read from %globaltimer from the kernel's start. On
// expiry the block records (what it waited for, where, block, call) in the
// rank's status words, once, and returns; it never traps, which would kill
// the context. The group reads the status when it next waits for the rank
// and raises TimeoutError.
//
// Instances: f32 {add, max, min, mul}, bf16 add and int32 add for the
// allreduce; f32 add for the reduce-scatter; f32 for the allgather; f32
// {add, max} for the quantized ring. Any other combination returns
// kErrUnsupported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

enum Kind { kAllreduce = 0, kReduceScatter = 1, kAllgather = 2 };
enum DType { kF32 = 0, kBF16 = 1, kI32 = 2 };
enum Op { kAdd = 0, kMax = 1, kMin = 2, kMul = 3 };
// what a timed-out block waited for (status word 0); word 1 is the ring's
// hop for the first two and the awaited rank for the others
enum Waited { kWaitedData = 1, kWaitedAck = 2, kWaitedMail = 3,
              kWaitedDone = 4, kWaitedAddrs = 5 };

constexpr int kThreads = 512;   // direct kernels: threads a block
constexpr int kQThreads = 256;  // quantized: 8 warps, a quant block each
constexpr int kQuantBlock = 256;
constexpr int kUnroll = 4;      // 16-byte loads in flight a thread (source)
constexpr int kErrUnsupported = 10000;

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

__device__ __forceinline__ unsigned long long ld_relaxed_u64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
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

// A load through L2 only (see the header).
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

// A streaming (evict-first) store.
template <typename T, int V>
__device__ __forceinline__ void store_cs(T* p, const Vec<T, V>& v) {
  if constexpr (sizeof(T) * V == 16) {
    uint4 raw;
    memcpy(&raw, &v, 16);
    __stcs(reinterpret_cast<uint4*>(p), raw);
  } else if constexpr (sizeof(T) * V == 4) {
    unsigned raw;
    memcpy(&raw, &v, 4);
    __stcs(reinterpret_cast<unsigned*>(p), raw);
  } else {
    static_assert(sizeof(T) * V == 2, "2-, 4- or 16-byte accesses");
    unsigned short raw;
    memcpy(&raw, &v, 2);
    __stcs(reinterpret_cast<unsigned short*>(p), raw);
  }
}

// The block's slice of a chunk; a multiple of 8 elements wide, so that
// every slice starts on a 16-byte boundary when the chunk does.
__device__ __forceinline__ void slice(long long chunk, long long* lo,
                                      long long* hi) {
  const long long per = ((chunk + gridDim.x - 1) / gridDim.x + 7) / 8 * 8;
  *lo = per * blockIdx.x;
  *hi = min(chunk, *lo + per);
}

// The rank after p, mod w.
__device__ __forceinline__ int succ(int p, int w) {
  return p + 1 == w ? 0 : p + 1;
}

// ---------------------------------------------------------------------------
// the direct kernels (B5, B6, B7; see the header)
// ---------------------------------------------------------------------------

struct DirectArgs {
  const void* x;
  void* out;
  // [2][world] addresses: rank p's mailbox (u64 input and output
  // addresses, then the u32 sequence number of the call that published
  // them), then rank p's done flags ([world][nblocks] u32, set by the
  // source ranks)
  const unsigned long long* peers;
  int* status;
  long long chunk;  // elements a rank's chunk (B7: a rank's payload)
  int world, rank;
  unsigned seq;
  unsigned long long timeout_ns;
};

// Publishes this call's input and output addresses in the rank's mailbox
// and reads every rank's into src[] and dst[] (shared memory). False,
// with the status recorded as `waited`, when a peer's mailbox did not
// come in time. *aligned: every address a multiple of 16 bytes.
__device__ bool exchange(const DirectArgs& a, int waited,
                         unsigned long long* src, unsigned long long* dst,
                         unsigned long long deadline, bool* aligned) {
  const int w = a.world, r = a.rank;
  unsigned long long* const* mail =
      reinterpret_cast<unsigned long long* const*>(a.peers);
  const unsigned long long x = reinterpret_cast<unsigned long long>(a.x);
  const unsigned long long out = reinterpret_cast<unsigned long long>(a.out);
  if (threadIdx.x == 0) {
    mail[r][0] = x;
    mail[r][1] = out;
    st_release(reinterpret_cast<unsigned*>(mail[r] + 2), a.seq);
  }
  int good = 1, al = 1;
  for (int p = threadIdx.x; p < w; p += blockDim.x) {
    unsigned long long in_p = x, out_p = out;
    if (p != r) {
      if (good && spin_until(reinterpret_cast<const unsigned*>(mail[p] + 2),
                             a.seq, deadline)) {
        in_p = ld_relaxed_u64(mail[p]);
        out_p = ld_relaxed_u64(mail[p] + 1);
      } else {
        if (good) record_timeout(a.status, waited, p, a.seq);
        good = 0;
      }
    }
    src[p] = in_p;
    dst[p] = out_p;
    al &= (in_p | out_p) % 16 == 0;
  }
  *aligned = __syncthreads_and(al) != 0;
  return __syncthreads_and(good) != 0;
}

// Posts this block's done flag to every peer, then waits for every peer's
// done flag of this block.
__device__ void done_round(const DirectArgs& a,
                           unsigned long long deadline) {
  const int w = a.world, r = a.rank;
  unsigned* const* done = reinterpret_cast<unsigned* const*>(a.peers + w);
  __syncthreads();  // the block's loads and stores come first
  for (int p = threadIdx.x; p < w; p += blockDim.x) {
    if (p == r) continue;
    __threadfence_system();
    st_release(done[p] + r * gridDim.x + blockIdx.x, a.seq);
  }
  for (int p = threadIdx.x; p < w; p += blockDim.x) {
    if (p == r) continue;
    if (!spin_until(done[r] + p * gridDim.x + blockIdx.x, a.seq, deadline)) {
      record_timeout(a.status, kWaitedDone, p, a.seq);
      break;
    }
  }
}

// B5 (ALL) and B6: the block's slice [lo, hi) of chunk r, folded over the
// w sources first, first + 1, ... (mod w) from offset r * C of each; B5
// stores the result at the same offset of every rank's output, its own
// first, B6 into its own output at offset 0. U loads of V elements in
// flight a thread and source.
template <typename T, int OP, bool ALL, int V, int U>
__device__ void fold(const unsigned long long* src,
                     const unsigned long long* dst, int w, int r, int first,
                     long long off, T* out, long long lo, long long hi) {
  const long long step = static_cast<long long>(blockDim.x) * V;
  for (long long i0 = lo + static_cast<long long>(threadIdx.x) * V; i0 < hi;
       i0 += step * U) {
    Vec<T, V> acc[U];
    const T* x0 = reinterpret_cast<const T*>(src[first]) + off;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u * step < hi) acc[u] = load_cg<T, V>(x0 + i0 + u * step);
    for (int k = 1, p = succ(first, w); k < w; ++k, p = succ(p, w)) {
      const T* xp = reinterpret_cast<const T*>(src[p]) + off;
      Vec<T, V> v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u * step < hi) v[u] = load_cg<T, V>(xp + i0 + u * step);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[u].v[j] = Combine<T, OP>::f(acc[u].v[j], v[u].v[j]);
    }
    if constexpr (ALL) {
      for (int k = 0, d = r; k < w; ++k, d = succ(d, w)) {
        T* o = reinterpret_cast<T*>(dst[d]) + off;
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (i0 + u * step < hi) store_cs<T, V>(o + i0 + u * step, acc[u]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u * step < hi) store_cs<T, V>(out + i0 + u * step, acc[u]);
    }
  }
}

// The vector path, where every buffer is 16-byte aligned. B5 reads and
// writes every buffer at offset r * C, so it goes V wide from the first
// 16-byte boundary of its chunk (`head` elements in): block b takes its
// slice shifted by head, block 0 also the head, and each block's last
// elements short of V go one at a time. B6 writes its output at offset
// 0, so it goes V wide only where r * C is a multiple of V (the sharded
// layout's chunks are multiples of 256).
template <typename T, int OP, bool ALL>
__global__ void __launch_bounds__(kThreads) direct_reduce(DirectArgs a) {
  extern __shared__ unsigned long long addrs[];  // src[w], dst[w]
  const int w = a.world, r = a.rank;
  const long long C = a.chunk;
  long long lo, hi;
  slice(C, &lo, &hi);
  if (lo >= hi) return;  // the same on every rank
  const unsigned long long deadline = globaltimer() + a.timeout_ns;
  bool aligned;
  if (!exchange(a, kWaitedAddrs, addrs, addrs + w, deadline, &aligned))
    return;
  const int first = ALL ? r : succ(r, w);
  const long long off = static_cast<long long>(r) * C;
  T* out = static_cast<T*>(a.out);
  const unsigned long long *src = addrs, *dst = addrs + w;
  constexpr int kVec = 16 / sizeof(T);
  const long long head = min(C, (kVec - off % kVec) % kVec);
  if (aligned && (ALL || head == 0)) {
    if (blockIdx.x == 0)
      fold<T, OP, ALL, 1, 1>(src, dst, w, r, first, off, out, 0, head);
    const long long b = min(C, lo + head), e = min(C, hi + head);
    const long long mid = b + (e - b) / kVec * kVec;
    fold<T, OP, ALL, kVec, kUnroll>(src, dst, w, r, first, off, out, b, mid);
    fold<T, OP, ALL, 1, 1>(src, dst, w, r, first, off, out, mid, e);
  } else {
    fold<T, OP, ALL, 1, kUnroll>(src, dst, w, r, first, off, out, lo, hi);
  }
  done_round(a, deadline);
}

// B7: the block's slice [lo, hi) of x into slot r of every rank's output,
// its own first.
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
      if (i0 + u * step < hi) v[u] = load_cg<float, V>(x + i0 + u * step);
    for (int k = 0, d = first; k < w; ++k, d = succ(d, w)) {
      float* o = reinterpret_cast<float*>(dst[d]) + off;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u * step < hi) store_cs<float, V>(o + i0 + u * step, v[u]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) direct_allgather(DirectArgs a) {
  extern __shared__ unsigned long long addrs[];  // src[w], dst[w]
  const int w = a.world, r = a.rank;
  const long long C = a.chunk;
  long long lo, hi;
  slice(C, &lo, &hi);
  if (lo >= hi) return;  // the same on every rank
  const unsigned long long deadline = globaltimer() + a.timeout_ns;
  bool aligned;
  if (!exchange(a, kWaitedMail, addrs, addrs + w, deadline, &aligned))
    return;
  const float* x = static_cast<const float*>(a.x);
  const long long off = static_cast<long long>(r) * C;
  if (aligned && C % 4 == 0)  // loads at offset 0, stores at r * C
    scatter<4, kUnroll>(x, addrs + w, w, r, off, lo, hi);
  else
    scatter<1, kUnroll>(x, addrs + w, w, r, off, lo, hi);
  done_round(a, deadline);
}

// ---------------------------------------------------------------------------
// the quantized ring's hop protocol (B8; see the header)
// ---------------------------------------------------------------------------

struct RingArgs {
  const float* x;
  float* out;
  signed char* recv;     // own slots [hops][chunk], written by the left
  signed char* recv_right;  // the right neighbour's slots
  float* srecv;          // own scale slots [hops][chunk / 256]
  float* srecv_right;
  unsigned* flags;       // own [hops][nblocks], set by the left neighbour
  unsigned* flags_right;
  unsigned* acks;        // own [hops][nblocks], set by the right neighbour
  unsigned* acks_left;
  int* status;           // own [4]: waited, hop, block, call
  long long chunk;
  int world, rank;
  unsigned seq;
  unsigned long long timeout_ns;
};

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

__device__ __forceinline__ int mod(int a, int w) { return ((a % w) + w) % w; }

// The (hop, block) flag of a [hops][nblocks] buffer.
__device__ __forceinline__ unsigned* flag(unsigned* base, int h) {
  return base + h * gridDim.x + blockIdx.x;
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
  const float* x = a.x;
  float* out = a.out;
  const QSlots own{a.recv, a.srecv};
  const QSlots right{a.recv_right, a.srecv_right};
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
int launch_direct(K kernel, int nblocks, const DirectArgs& a,
                  cudaStream_t s) {
  const size_t smem = 2 * sizeof(unsigned long long) * a.world;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<nblocks, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One direct collective of one rank, on `stream`; does not synchronise.
// kind: 0 allreduce (B5), 1 reduce-scatter (B6), 2 allgather (B7). dtype:
// 0 f32, 1 bf16, 2 int32. op: 0 add, 1 max, 2 min, 3 mul. x: the rank's
// input, [world][chunk] (B7: [chunk]); out: its output, [world][chunk]
// (B6: [chunk]). peers: the group's device table of [2][world] addresses
// (every rank's mailbox, then every rank's [world][nblocks] done flags),
// as DirectArgs says. Every rank of a call passes the same kind, dtype,
// op, chunk, nblocks and seq. Returns the cudaError_t of the launch, or
// kErrUnsupported for an instance that is not built.
int direct_launch(int kind, int dtype, int op, const void* x, void* out,
                  const unsigned long long* peers, int* status,
                  long long chunk, int world, int rank, int nblocks,
                  unsigned seq, unsigned long long timeout_ns,
                  void* stream) {
  if (chunk <= 0 || world < 1 || rank < 0 || rank >= world || nblocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  DirectArgs a{x, out, peers, status, chunk, world, rank, seq, timeout_ns};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kAllreduce) {
    if (dtype == kF32 && op == kAdd)
      return launch_direct(direct_reduce<float, kAdd, true>, nblocks, a, s);
    if (dtype == kF32 && op == kMax)
      return launch_direct(direct_reduce<float, kMax, true>, nblocks, a, s);
    if (dtype == kF32 && op == kMin)
      return launch_direct(direct_reduce<float, kMin, true>, nblocks, a, s);
    if (dtype == kF32 && op == kMul)
      return launch_direct(direct_reduce<float, kMul, true>, nblocks, a, s);
    if (dtype == kBF16 && op == kAdd)
      return launch_direct(direct_reduce<__nv_bfloat16, kAdd, true>, nblocks,
                           a, s);
    if (dtype == kI32 && op == kAdd)
      return launch_direct(direct_reduce<int, kAdd, true>, nblocks, a, s);
    return kErrUnsupported;
  }
  if (dtype != kF32 || op != kAdd) return kErrUnsupported;
  if (kind == kReduceScatter)
    return launch_direct(direct_reduce<float, kAdd, false>, nblocks, a, s);
  if (kind == kAllgather)
    return launch_direct(direct_allgather, nblocks, a, s);
  return kErrUnsupported;
}

// One quantized ring allreduce (B8) of one rank, on `stream`; does not
// synchronise. op: 0 add, 1 max. x, out: f32 [world][chunk], chunk a
// multiple of 256, both 16-byte aligned. The slot, flag and ack buffers
// are the group's, laid out as RingArgs says; every rank of a call passes
// the same chunk, nblocks and seq. Returns the cudaError_t of the launch,
// or kErrUnsupported for an instance that is not built.
int quantized_launch(int op, const float* x, float* out, signed char* recv,
                     signed char* recv_right, float* srecv,
                     float* srecv_right, unsigned* flags,
                     unsigned* flags_right, unsigned* acks,
                     unsigned* acks_left, int* status, long long chunk,
                     int world, int rank, int nblocks, unsigned seq,
                     unsigned long long timeout_ns, void* stream) {
  if (chunk <= 0 || world < 1 || rank < 0 || rank >= world || nblocks < 1 ||
      chunk % kQuantBlock != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(recv) |
       reinterpret_cast<uintptr_t>(recv_right)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  RingArgs a{x,     out,         recv, recv_right,  srecv,
             srecv_right, flags, flags_right, acks, acks_left,
             status, chunk, world, rank, seq, timeout_ns};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == kAdd) {
    ring_allreduce_q<kAdd><<<nblocks, kQThreads, 0, s>>>(a);
  } else if (op == kMax) {
    ring_allreduce_q<kMax><<<nblocks, kQThreads, 0, s>>>(a);
  } else {
    return kErrUnsupported;
  }
  return static_cast<int>(cudaGetLastError());
}

// Lets the current device's kernels reach `peer`'s memory (ranks on
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
