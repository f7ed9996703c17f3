// Fused collectives for Hopper (sm_90a): one kernel per op and rank.
//
// Replaces the four TPU kernels of
// ray_tpu/collective/backends/pallas_backend.py:
//   direct_reduce<ALL>   <- _make_allreduce_kernel (B5): exact allreduce
//                           (add, max, min, mul), in the ring's combine
//                           order, not a ring on this card; see below;
//   direct_reduce<RS>    <- _make_reducescatter_kernel (B6): SUM, rank r
//                           ends with reduced chunk r (the ring's
//                           delta = -1), likewise direct;
//   direct_allgather     <- _make_allgather_kernel (B7): direct;
//   quantized_allreduce  <- _make_quantized_allreduce_kernel (B8): the
//                           EQuARX int8 allreduce, its reduce half the
//                           ring's hops (each re-quantizes the partial to
//                           int8 + one f32 scale per 256 values), its
//                           gather half direct; see below.
// Each rank of a group launches its kernel on its own stream. The ranks
// may share one card or sit on several cards with peer access, in one
// process or in processes of their own; the code is the same.
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
// The protocol, one for B5-B8. A peer's buffers of a call are not known
// when a rank is launched: each rank publishes two addresses of its call
// in its mailbox (B5, B6: input and output; B7: output; B8: its staging
// buffer's payload and scales), then a release store (st.release.sys) of
// the call's sequence number, and every block acquires (ld.acquire.sys)
// every peer's before it touches a peer's memory. Ranks in processes of
// their own cannot use a peer's address: each maps the peers' buffers of
// a class once through CUDA IPC (ring_ipc_*), the caller copies a call's
// payload into and out of those buffers, and the launch passes a table of
// the peers' two addresses as this process maps them (`fixed`).
//
// Processes that share a card do not run at the same time: the card
// switches between their contexts, so a kernel that spins for a peer's
// kernel of another process holds its time-slice while the peer cannot
// run, and a call takes several slices. Across processes the kernels
// therefore never wait: a launch names one phase of the call
// (`phase` >= 0) and does only that phase's loads and stores, and the
// caller orders the phases of the ranks with CUDA IPC events (the host
// waits until a peer has recorded the event of the phase, then the
// rank's stream waits for it; ring_event_*):
//   B5, B6, B7: phase 0, the fold or the scatter, after every rank's
//     input is in its buffer and every rank has read its previous output
//     out of its buffer; then every rank's phase 0 is awaited before a
//     rank reads its output or reuses its input buffer.
//   B8: phase 0 quantizes chunk r into the right neighbour's slot 0;
//     phase s = 1 .. w - 1 is hop s (after the left neighbour's phase
//     s - 1), the last one staging the reduced chunk; phase w dequantizes
//     every peer's staged chunk (after every peer's phase w - 1).
// The mailbox and done flags are the protocol of ranks in one process
// (`phase` = -1), where all ranks' kernels can run at once: a wait for a
// rank that never launched is the first wait of every peer, and each
// names that rank. Block b of rank r works on
// slice b of its chunk(s) and talks only to block b of the peers (no grid
// sync): it ends by posting a done flag, per (source rank, block), to each
// peer (release), and returns only once its own w - 1 done flags for block
// b have arrived. So when a rank's kernel ends, every peer has finished
// reading its buffers and writing its output, and neither those buffers,
// its slots nor its mailbox are still in use when the caller reuses them
// or the next call publishes. Rank p's mailbox and flags reach the kernel
// through a device table of addresses made once per buffer class ([2][w]:
// mailboxes, flags; B8 [3][w]: also the hop slots); no world-size limit.
// Each thread keeps 4 16-byte loads in flight a source (loads through L2
// only, ld.global.cg, never a stale L1 line of a peer's buffer), then
// stores each result once to each destination, streaming (evict-first):
// no byte is touched twice. In one process the grid is capped by the
// caller at SMs / (2 * ranks on the card) blocks, so that every rank's
// kernel fits on the card beside the others' work: a rank's blocks spin on
// flags that another rank's kernel sets, and a spinning block must never
// keep its partner from running. A phase launch waits for nothing and
// takes as many blocks as the caller gives it.
//
// The quantized allreduce (B8). Its wire is int8: every byte one rank's
// kernel stores into, or reads from, another rank's memory is int8 payload
// or an f32 scale, never the f32 values (reading the peers' f32 inputs, as
// B5 does, would send four times the bytes over NVLink). Chunk c of C
// values starts on rank c and is folded with x_{c+1}[c], ..., x_{c+w-1}[c]
// in that order (the reference's ring), re-quantized after every combine:
//   reduce half, w - 1 hops: rank r quantizes its chunk r into slot 0 of
//     its right neighbour r + 1 (push); at hop s = 1 .. w - 1 it waits for
//     its slot s - 1, dequantizes it, combines it with x_r[r - s] and
//     quantizes the result into slot s of its right neighbour, or, at the
//     last hop, into its own staging buffer: rank r ends with reduced chunk
//     r + 1, quantized once, and dequantizes it into its own output;
//   gather half, direct (pull): every peer o's reduced chunk o + 1 is read
//     from o's staging buffer (its address from o's mailbox) and
//     dequantized into the output; every rank dequantizes the same bytes.
// The gather is one read of each staged chunk a peer, not the reference's
// w - 1 relay hops. Bytes a call over all ranks, with c = C (1 + 4/256)
// the bytes of a quantized chunk: each rank's input read once and output
// written once (8 w C), plus the wire, (3w - 2) c a rank: w - 1 hop slots
// written and read, the staged chunk written once and read by w - 1
// peers. Block b of every rank works on quant blocks b*per .. of every
// chunk, 512 threads, a warp per 256-value quant block and 4 of them in
// flight a warp in the reduce half (8 in the gather): every 16-byte load
// of x and every load of a slot's payload and scale is issued before the
// first reduction. Lane l holds values 4l..4l+3 and 128+4l..128+4l+3 of its
// quant block (each 16-byte load covers 512 contiguous bytes across the
// warp), and its 8 int8 values go to bytes 8l..8l+7 of the block's 256 on
// the wire (one 8-byte store a lane): the wire's order within a quant
// block is the kernel's own, read back the same way. A hop's slot is
// flagged per (hop, block) by the sender, the staged chunk per (owner,
// block) to every peer. The quantizer is absmax / 127 and x / scale as
// IEEE divisions (__fdiv_rn), a rounding half to even (as torch.round and
// jnp.round), a clamp to +-127 and a scale of 1.0 for an all-zero block;
// dequantize-and-combine is __fmul_rn then the combine. The int8
// conversions are FP32 and byte arithmetic (quantize8, dequantize4):
// the conversion units run at a quarter of the FP32 rate, and with only
// the grid cap's SMs the kernel's instructions, not its bytes, bound it.
//
// A dead or late rank aborts, it does not hang: every spin is bounded by
// the group's timeout, read from %globaltimer from the kernel's start. On
// expiry the block records (what it waited for, the awaited rank, block,
// call) in the rank's status words, once, and returns; it never traps,
// which would kill the context. The group reads the status when it next
// waits for the rank and raises TimeoutError.
//
// Instances: f32 {add, max, min, mul}, bf16 add and int32 add for the
// allreduce; f32 add for the reduce-scatter; f32 for the allgather; f32
// {add, max, min} for the quantized allreduce. Any other combination
// returns kErrUnsupported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

enum Kind { kAllreduce = 0, kReduceScatter = 1, kAllgather = 2 };
enum DType { kF32 = 0, kBF16 = 1, kI32 = 2 };
enum Op { kAdd = 0, kMax = 1, kMin = 2, kMul = 3 };
// what a timed-out block waited for (status word 0; word 1 is the awaited
// rank): a peer's mailbox (B7 its output address, B5 and B6 its input and
// output addresses, B8 its staging addresses), B8's int8 partial of a hop
// from the left neighbour and a peer's staged reduced chunk, a done flag
enum Waited { kWaitedMail = 1, kWaitedAddrs = 2, kWaitedStage = 3,
              kWaitedPartial = 4, kWaitedChunk = 5, kWaitedDone = 6 };

constexpr int kThreads = 512;  // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // 16-byte loads in flight a thread (source)
constexpr int kQuantBlock = 256;
constexpr int kQUnroll = 4;    // B8: quant blocks in flight a warp, reduce
constexpr int kGUnroll = 8;    // B8: the same, gather
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
// what, the awaited rank, block, call.
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
// the protocol (B5-B8; see the header)
// ---------------------------------------------------------------------------

struct DirectArgs {
  const void* x;
  void* out;
  // [2][world] addresses (B8 [3][world]): rank p's mailbox (two u64
  // addresses, then the u32 sequence number of the call that published
  // them), then rank p's flags ([rows][nblocks] u32: rows 0 .. w - 1 the
  // done flags, set by the source ranks; B8 then the staged-chunk flags,
  // set by their owners, and the hop flags, set by the left neighbour),
  // then (B8) rank p's hop slots
  const unsigned long long* peers;
  int* status;
  long long chunk;  // elements a rank's chunk (B7: a rank's payload)
  int world, rank;
  unsigned seq;
  unsigned long long timeout_ns;
  void* stage;  // B8: the rank's staging buffer
  // [2][world] addresses of every peer's two buffers of the call as this
  // process maps them (see the header), or null: the mailboxes' own
  const unsigned long long* fixed;
  int phase;  // -1: the whole call, spinning for the peers; else one phase
};

// Publishes this call's two addresses (mine0, mine1) in the rank's mailbox
// and reads every rank's into src[] and dst[] (shared memory). False,
// with the status recorded as `waited`, when a peer's mailbox did not
// come in time. *aligned: every address a multiple of 16 bytes.
__device__ bool exchange(const DirectArgs& a, unsigned long long mine0,
                         unsigned long long mine1, int waited,
                         unsigned long long* src, unsigned long long* dst,
                         unsigned long long deadline, bool* aligned) {
  const int w = a.world, r = a.rank;
  if (a.phase >= 0) {  // the caller ordered the phases: no mailbox round
    int al = 1;
    for (int p = threadIdx.x; p < w; p += blockDim.x) {
      src[p] = p == r ? mine0 : a.fixed[p];
      dst[p] = p == r ? mine1 : a.fixed[w + p];
      al &= (src[p] | dst[p]) % 16 == 0;
    }
    *aligned = __syncthreads_and(al) != 0;
    return true;
  }
  unsigned long long* const* mail =
      reinterpret_cast<unsigned long long* const*>(a.peers);
  if (threadIdx.x == 0) {
    mail[r][0] = mine0;
    mail[r][1] = mine1;
    st_release(reinterpret_cast<unsigned*>(mail[r] + 2), a.seq);
  }
  int good = 1, al = 1;
  for (int p = threadIdx.x; p < w; p += blockDim.x) {
    unsigned long long a0 = mine0, a1 = mine1;
    if (p != r) {
      if (good && spin_until(reinterpret_cast<const unsigned*>(mail[p] + 2),
                             a.seq, deadline)) {
        a0 = a.fixed ? a.fixed[p] : ld_relaxed_u64(mail[p]);
        a1 = a.fixed ? a.fixed[w + p] : ld_relaxed_u64(mail[p] + 1);
      } else {
        if (good) record_timeout(a.status, waited, p, a.seq);
        good = 0;
      }
    }
    src[p] = a0;
    dst[p] = a1;
    al &= (a0 | a1) % 16 == 0;
  }
  *aligned = __syncthreads_and(al) != 0;
  return __syncthreads_and(good) != 0;
}

// Rank p's flags.
__device__ __forceinline__ unsigned* flags_of(const DirectArgs& a, int p) {
  return reinterpret_cast<unsigned* const*>(a.peers + a.world)[p];
}

// The block's flag in row `row` of a flags buffer.
__device__ __forceinline__ unsigned* flag(unsigned* flags, int row) {
  return flags + row * gridDim.x + blockIdx.x;
}

// After the block's loads and stores: sets its flag in row `row` of every
// peer's flags.
__device__ void post_peers(const DirectArgs& a, int row) {
  __syncthreads();
  for (int p = threadIdx.x; p < a.world; p += blockDim.x) {
    if (p == a.rank) continue;
    __threadfence_system();
    st_release(flag(flags_of(a, p), row), a.seq);
  }
}

// After the block's loads and stores: sets one flag.
__device__ void post(const DirectArgs& a, unsigned* f) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    st_release(f, a.seq);
  }
}

// The block waits for one flag of this call. False, with the status
// recorded (`waited`, rank `peer`), on timeout.
__device__ bool block_wait(const DirectArgs& a, const unsigned* f,
                           int waited, int peer,
                           unsigned long long deadline) {
  int good = 1;
  if (threadIdx.x == 0 && !spin_until(f, a.seq, deadline)) {
    record_timeout(a.status, waited, peer, a.seq);
    good = 0;
  }
  return __syncthreads_and(good) != 0;
}

// Posts this block's done flag to every peer, then waits for every peer's
// done flag of this block.
__device__ void done_round(const DirectArgs& a,
                           unsigned long long deadline) {
  const int w = a.world, r = a.rank;
  post_peers(a, r);
  for (int p = threadIdx.x; p < w; p += blockDim.x) {
    if (p == r) continue;
    if (!spin_until(flag(flags_of(a, r), p), a.seq, deadline)) {
      record_timeout(a.status, kWaitedDone, p, a.seq);
      break;
    }
  }
}

// ---------------------------------------------------------------------------
// the direct kernels (B5, B6, B7; see the header)
// ---------------------------------------------------------------------------

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
  if (!exchange(a, reinterpret_cast<unsigned long long>(a.x),
                reinterpret_cast<unsigned long long>(a.out), kWaitedAddrs,
                addrs, addrs + w, deadline, &aligned))
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
  if (a.phase < 0) done_round(a, deadline);
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
  if (!exchange(a, reinterpret_cast<unsigned long long>(a.x),
                reinterpret_cast<unsigned long long>(a.out), kWaitedMail,
                addrs, addrs + w, deadline, &aligned))
    return;
  const float* x = static_cast<const float*>(a.x);
  const long long off = static_cast<long long>(r) * C;
  if (aligned && C % 4 == 0)  // loads at offset 0, stores at r * C
    scatter<4, kUnroll>(x, addrs + w, w, r, off, lo, hi);
  else
    scatter<1, kUnroll>(x, addrs + w, w, r, off, lo, hi);
  if (a.phase < 0) done_round(a, deadline);
}

// ---------------------------------------------------------------------------
// B8: the quantized allreduce (see the header). A warp owns one 256-value
// quant block at a time; lane l its values 4l..4l+3 and 128+4l..128+4l+3
// and wire bytes 8l..8l+7.
// ---------------------------------------------------------------------------

// A quantized chunk: int8 payload [C] in wire order, f32 scales [C / 256].
struct QBuf {
  signed char* q;
  float* s;
};

// Slot h of a rank's hop slots: [w - 1][C] int8, then [w - 1][C / 256]
// f32.
__device__ __forceinline__ QBuf slot(signed char* base, int h, int w,
                                     long long C) {
  const long long hops = w - 1;
  return {base + h * C,
          reinterpret_cast<float*>(base + hops * C) + h * (C / kQuantBlock)};
}

// A staging buffer: [C] int8, then [C / 256] f32.
__device__ __forceinline__ QBuf stage(void* base, long long C) {
  signed char* q = static_cast<signed char*>(base);
  return {q, reinterpret_cast<float*>(q + C)};
}

// The lane's 8 values of quant block qb.
__device__ __forceinline__ void load_vals(const float* x, long long qb,
                                          int lane, float (&v)[8]) {
  const float* p = x + qb * kQuantBlock + 4 * lane;
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p + 128));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store_vals(float* out, long long qb,
                                           int lane, const float (&v)[8]) {
  float* p = out + qb * kQuantBlock + 4 * lane;
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p + 128),
         make_float4(v[4], v[5], v[6], v[7]));
}

// The int8 conversions stay off the card's conversion units (a quarter of
// the FP32 rate), exactly: t in [-127, 127] rounds half to even to an
// integer as t + 1.5 * 2^23, whose low byte is that integer's, and an
// int8 b is (2^23 + (b ^ 0x80)) - (2^23 + 128), the first term made by
// placing the byte under 2^23's exponent.
constexpr float kRound = 12582912.0f;  // 1.5 * 2^23
constexpr float kBias = 8388736.0f;    // 2^23 + 128

// Four rounded values' low bytes, in order, as one word.
__device__ __forceinline__ unsigned pack4(float a, float b, float c,
                                          float d) {
  return __byte_perm(
      __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x0040),
      __byte_perm(__float_as_uint(c), __float_as_uint(d), 0x0040), 0x5410);
}

// The warp's quant block: its scale (absmax / 127, 1 for an all-zero
// block) and the lane's 8 int8 values: rint(v / scale) clamped to +-127
// (the clamp first, which gives the same integers).
__device__ __forceinline__ uint2 quantize8(const float (&v)[8],
                                           float* scale) {
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
  // m >= 0 and never NaN, so its bits order as the values do
  m = __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(m)));
  const float s = m > 0.f ? __fdiv_rn(m, 127.0f) : 1.0f;
  float t[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    t[j] = __fadd_rn(fminf(fmaxf(__fdiv_rn(v[j], s), -127.f), 127.f),
                     kRound);
  *scale = s;
  return make_uint2(pack4(t[0], t[1], t[2], t[3]),
                    pack4(t[4], t[5], t[6], t[7]));
}

__device__ __forceinline__ void dequantize4(unsigned q, float scale,
                                            float* v) {
  const unsigned k = q ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = __fmul_rn(
        __fsub_rn(__uint_as_float(__byte_perm(k, 0x4B000000u, 0x7440 + j)),
                  kBias),
        scale);
}

__device__ __forceinline__ void dequantize8(uint2 q, float scale,
                                            float (&v)[8]) {
  dequantize4(q.x, scale, v);
  dequantize4(q.y, scale, v + 4);
}

// One hop of the reduce half over quant blocks [qlo, qhi) of a chunk:
// v = x, or (IN) cmb(dequantized slot `in`, x); v quantized into `to`;
// (OUT) the dequantized result into out. kQUnroll quant blocks a warp in
// flight, every load issued before the first reduction.
template <int OP, bool IN, bool OUT>
__device__ void requant(const float* x, QBuf in, QBuf to, float* out,
                        long long qlo, long long qhi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (long long q0 = qlo + warp; q0 < qhi; q0 += kWarps * kQUnroll) {
    float v[kQUnroll][8];
    uint2 qi[kQUnroll];
    float si[kQUnroll];
#pragma unroll
    for (int u = 0; u < kQUnroll; ++u) {
      const long long qb = q0 + u * kWarps;
      if (qb < qhi) {
        load_vals(x, qb, lane, v[u]);
        if constexpr (IN) {
          qi[u] = __ldcg(reinterpret_cast<const uint2*>(
                             in.q + qb * kQuantBlock) + lane);
          si[u] = __ldcg(in.s + qb);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kQUnroll; ++u) {
      const long long qb = q0 + u * kWarps;  // the same on every lane
      if (qb < qhi) {
        if constexpr (IN) {
          float d[8];
          dequantize8(qi[u], si[u], d);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[u][j] = Combine<float, OP>::f(d[j], v[u][j]);
        }
        float s;
        const uint2 q = quantize8(v[u], &s);
        reinterpret_cast<uint2*>(to.q + qb * kQuantBlock)[lane] = q;
        if (lane == 0) to.s[qb] = s;
        if constexpr (OUT) {
          dequantize8(q, s, v[u]);
          store_vals(out, qb, lane, v[u]);
        }
      }
    }
  }
}

// The gather half: quant blocks [qlo, qhi) of a staged chunk, dequantized
// into out; kGUnroll a warp in flight.
__device__ void dequant(QBuf in, float* out, long long qlo, long long qhi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (long long q0 = qlo + warp; q0 < qhi; q0 += kWarps * kGUnroll) {
    uint2 qi[kGUnroll];
    float si[kGUnroll];
#pragma unroll
    for (int u = 0; u < kGUnroll; ++u) {
      const long long qb = q0 + u * kWarps;
      if (qb < qhi) {
        qi[u] = __ldcg(reinterpret_cast<const uint2*>(
                           in.q + qb * kQuantBlock) + lane);
        si[u] = __ldcg(in.s + qb);
      }
    }
#pragma unroll
    for (int u = 0; u < kGUnroll; ++u) {
      const long long qb = q0 + u * kWarps;
      if (qb < qhi) {
        float v[8];
        dequantize8(qi[u], si[u], v);
        store_vals(out, qb, lane, v);
      }
    }
  }
}

template <int OP>
__global__ void __launch_bounds__(kThreads) quantized_allreduce(
    DirectArgs a) {
  extern __shared__ unsigned long long addrs[];  // stages: q[w], s[w]
  const int w = a.world, r = a.rank;
  const long long C = a.chunk, nqb = C / kQuantBlock;
  const long long per = (nqb + gridDim.x - 1) / gridDim.x;
  const long long qlo = per * blockIdx.x, qhi = min(nqb, qlo + per);
  if (qlo >= qhi) return;  // the same on every rank
  const float* x = static_cast<const float*>(a.x);
  float* out = static_cast<float*>(a.out);
  const QBuf own = stage(a.stage, C);
  if (w == 1) {  // the reference quantizes and dequantizes its one chunk
    requant<OP, false, true>(x, QBuf{}, own, out, qlo, qhi);
    return;
  }
  signed char* const* slots =
      reinterpret_cast<signed char* const*>(a.peers + 2 * w);
  const int right = succ(r, w);
  if (a.phase >= 0) {  // one phase; the caller ordered it after its inputs
    const int s = a.phase;
    if (s == 0) {
      requant<OP, false, false>(x + r * C, QBuf{},
                                slot(slots[right], 0, w, C), nullptr, qlo,
                                qhi);
    } else if (s < w) {
      const int c = (r - s + w) % w;
      const QBuf in = slot(slots[r], s - 1, w, C);
      if (s < w - 1)
        requant<OP, true, false>(x + c * C, in, slot(slots[right], s, w, C),
                                 nullptr, qlo, qhi);
      else  // c = r + 1: the reduced chunk, staged and into the output
        requant<OP, true, true>(x + c * C, in, own, out + c * C, qlo, qhi);
    } else {
      for (int o = succ(r, w); o != r; o = succ(o, w))  // owner of o + 1
        dequant(QBuf{reinterpret_cast<signed char*>(a.fixed[o]),
                     reinterpret_cast<float*>(a.fixed[w + o])},
                out + succ(o, w) * C, qlo, qhi);
    }
    return;
  }
  const unsigned long long deadline = globaltimer() + a.timeout_ns;
  bool aligned;
  if (!exchange(a, reinterpret_cast<unsigned long long>(own.q),
                reinterpret_cast<unsigned long long>(own.s), kWaitedStage,
                addrs, addrs + w, deadline, &aligned))
    return;
  const int left = r == 0 ? w - 1 : r - 1;
  unsigned* const mine = flags_of(a, r);
  // flag rows: done [w], staged chunk by owner [w], hop [w - 1]
  const int kStaged = w, kHop = 2 * w;
  requant<OP, false, false>(x + r * C, QBuf{}, slot(slots[right], 0, w, C),
                            nullptr, qlo, qhi);
  post(a, flag(flags_of(a, right), kHop));
  for (int s = 1; s < w; ++s) {
    if (!block_wait(a, flag(mine, kHop + s - 1), kWaitedPartial, left,
                    deadline))
      return;
    const int c = (r - s + w) % w;
    const QBuf in = slot(slots[r], s - 1, w, C);
    if (s < w - 1) {
      requant<OP, true, false>(x + c * C, in, slot(slots[right], s, w, C),
                               nullptr, qlo, qhi);
      post(a, flag(flags_of(a, right), kHop + s));
    } else {  // c = r + 1: the reduced chunk, staged and into the output
      requant<OP, true, true>(x + c * C, in, own, out + c * C, qlo, qhi);
      post_peers(a, kStaged + r);
    }
  }
  for (int o = succ(r, w); o != r; o = succ(o, w)) {  // owner of o + 1
    if (!block_wait(a, flag(mine, kStaged + o), kWaitedChunk, o, deadline))
      return;
    dequant(QBuf{reinterpret_cast<signed char*>(addrs[o]),
                 reinterpret_cast<float*>(addrs[w + o])},
            out + succ(o, w) * C, qlo, qhi);
  }
  done_round(a, deadline);
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
// as DirectArgs says; fixed: null, or the peers' mapped inputs and
// outputs ([2][world]); phase: -1 (the mailbox protocol) or 0 (the fold or
// scatter alone, ordered by the caller; needs fixed). Every rank of a call passes the same kind, dtype,
// op, chunk, nblocks and seq. Returns the cudaError_t of the launch, or
// kErrUnsupported for an instance that is not built.
int direct_launch(int kind, int dtype, int op, const void* x, void* out,
                  const unsigned long long* peers,
                  const unsigned long long* fixed, int phase, int* status,
                  long long chunk, int world, int rank, int nblocks,
                  unsigned seq, unsigned long long timeout_ns,
                  void* stream) {
  if (chunk <= 0 || world < 1 || rank < 0 || rank >= world || nblocks < 1 ||
      phase < -1 || phase > 0 || (phase == 0 && !fixed))
    return static_cast<int>(cudaErrorInvalidValue);
  DirectArgs a{x,    out,  peers,      status,  chunk,
               world, rank, seq, timeout_ns, nullptr, fixed, phase};
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

// One quantized allreduce (B8) of one rank, on `stream`; does not
// synchronise. op: 0 add, 1 max, 2 min. x, out: f32 [world][chunk], chunk
// a multiple of 256, both 16-byte aligned. peers: the group's device table
// of [3][world] addresses (every rank's mailbox, its [3 world - 1][nblocks]
// flags and its hop slots), stage: this rank's staging buffer, fixed:
// null, or the peers' mapped staging payloads and scales ([2][world]);
// phase: -1 (the mailbox protocol) or 0 .. world (one phase, ordered by
// the caller; needs fixed), as DirectArgs and the header say. Every rank of a call passes the same op,
// chunk, nblocks and seq. Returns the cudaError_t of the launch, or
// kErrUnsupported for an instance that is not built.
int quantized_launch(int op, const float* x, float* out,
                     const unsigned long long* peers, void* stage,
                     const unsigned long long* fixed, int phase, int* status,
                     long long chunk, int world, int rank, int nblocks,
                     unsigned seq, unsigned long long timeout_ns,
                     void* stream) {
  if (chunk <= 0 || world < 1 || rank < 0 || rank >= world || nblocks < 1 ||
      phase < -1 || phase > world || (phase >= 0 && !fixed) ||
      chunk % kQuantBlock != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(stage)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DirectArgs a{x,    out,  peers,      status, chunk,
               world, rank, seq, timeout_ns, stage, fixed, phase};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == kAdd)
    return launch_direct(quantized_allreduce<kAdd>, nblocks, a, s);
  if (op == kMax)
    return launch_direct(quantized_allreduce<kMax>, nblocks, a, s);
  if (op == kMin)
    return launch_direct(quantized_allreduce<kMin>, nblocks, a, s);
  return kErrUnsupported;
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

// CUDA IPC for ranks in processes of their own: a class's buffers are
// one allocation a rank, zeroed before its handle is shared, and mapped
// once by every peer.

// A zeroed allocation of `bytes` on the current device (synchronised).
int ring_ipc_alloc(unsigned long long bytes, void** ptr) {
  cudaError_t err = cudaMalloc(ptr, bytes);
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}

// The allocation's handle, CUDA_IPC_HANDLE_SIZE (64) bytes.
int ring_ipc_handle(void* ptr, void* handle) {
  return static_cast<int>(
      cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), ptr));
}

// Maps a peer's allocation into this process (peer access enabled on
// demand where the peer's card is another).
int ring_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

int ring_ipc_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

int ring_ipc_free(void* ptr) { return static_cast<int>(cudaFree(ptr)); }

// Interprocess events: one a (rank, phase slot), recorded by its rank on
// its stream and awaited by the peers' streams.
int ring_event_create(void** event, void* handle) {
  cudaEvent_t ev;
  cudaError_t err = cudaEventCreateWithFlags(
      &ev, cudaEventDisableTiming | cudaEventInterprocess);
  if (err == cudaSuccess)
    err = cudaIpcGetEventHandle(static_cast<cudaIpcEventHandle_t*>(handle),
                                ev);
  *event = ev;
  return static_cast<int>(err);
}

int ring_event_open(const void* handle, void** event) {
  cudaIpcEventHandle_t h;
  memcpy(&h, handle, sizeof(h));
  cudaEvent_t ev;
  const cudaError_t err = cudaIpcOpenEventHandle(&ev, h);
  *event = ev;
  return static_cast<int>(err);
}

int ring_event_record(void* event, void* stream) {
  return static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(event),
                                          static_cast<cudaStream_t>(stream)));
}

int ring_stream_wait(void* stream, void* event) {
  return static_cast<int>(cudaStreamWaitEvent(
      static_cast<cudaStream_t>(stream), static_cast<cudaEvent_t>(event), 0));
}

int ring_event_destroy(void* event) {
  return static_cast<int>(cudaEventDestroy(static_cast<cudaEvent_t>(event)));
}

const char* ring_error_string(int code) {
  if (code == kErrUnsupported) return "instance not built";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
