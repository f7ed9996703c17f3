// Flash-attention forward for Hopper (sm_90a).
//
// Replaces ray_tpu/ops/attention.py::_flash_kernel (launched by
// _flash_fwd_impl). For q, k, v of shape [B, T, H, D], and each (b, h),
// query row i:
//     s_j = (q_i · k_j) · scale, with s_j = -1e30 where causal and j > i
//     o_i = Σ_j softmax(s)_j · v_j
// computed as the reference does: K and V in blocks of 128 keys, an online
// softmax with a running max m, denominator l and accumulator o in f32,
// the scan stopping at the last block a causal query tile can see, and
// o / l with an l > 0 guard at the end (in bf16 as o · (1 / l)). In bf16,
// p is cast to bf16 before the p·V product (the reference's
// `p.astype(v.dtype)`), while l sums the f32 p.
//
// Bound. At GPT-2's shape (B·H = 144, T = 1024, D = 64, causal) the work
// is 4·D flops per visible (query, key) pair, about 19.5 GFLOP, and the
// bytes are one read of q, k, v and one write of o, 75.5 MB: 20 µs of
// bf16 tensor-core time against 22.5 µs of memory time. The kernel sits at
// the ridge: it needs the tensor cores at their wgmma rate and loads that
// overlap the math.
//
// Design of the bf16 kernel (flash_fwd_bf16), built for D = 64:
// - One CTA of two warpgroups takes 128 query rows of one (b, h), 64 rows
//   a warpgroup (wgmma's M). Two CTAs share an SM (122 registers a
//   thread, 82 KB of shared memory each), so that one CTA's softmax runs
//   while the other's products and loads do. Under the causal stop the
//   longest query tiles launch first, 48 (b, h) pairs at a time
//   (kCausalGroup).
// - Loads by TMA, all issued by thread 0: the Q tile once, then each
//   128-key K and V tile into a ring of two stages, each with a full
//   barrier for K and one for V and an empty barrier that every consumer
//   warp arrives on. The tensor maps are 4-D over the caller's
//   [B, T, H, D] strides (q, k, v may be views into one qkv tensor: no
//   transposes, no copies), with a 64 x 128 box and the 128-byte swizzle
//   (64 bf16 = 128 B a row).
// - S = Q·Kᵀ by wgmma m64n128k16 with Q and K from shared memory, four
//   k-slices of 16 along D.
// - The online softmax stays in registers, in base 2: scale·log2(e) is
//   folded into one FMA ahead of ex2, and the row reductions run in four
//   chains. The causal mask is applied on the diagonal tile only.
// - P becomes bf16 A fragments in registers (the m64n128 accumulator's
//   layout is the A-operand layout of the next product), and O += P·V by
//   wgmma m64n64k16 with V read transposed (MN-major) from shared memory.
//   The first half of P·V (keys 0..63) runs on the tensor cores while the
//   exponentials of keys 64..127 are computed.
// - Every wgmma is issued outside any branch: ptxas serializes a wgmma on
//   a path it cannot prove uniform.
// The f32 kernel (flash_fwd_f32) runs the same online softmax on the CUDA
// cores for float32 models: 4 warps per 16-row query tile, a lane per key
// for the scores and a lane per output column for P·V.
// No atomics: every sum has a fixed order, so results are identical from
// run to run. The key block is the reference's 128 and T must be a
// multiple of it (its flash route's condition, `_flash_aligned`, at
// T >= 128); the bf16 kernel is built for D = 64 only, the head dim of
// every full-size model of the repo.

#include <cuda.h>  // CUtensorMap and its enums (the encoder: runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kThreads = 128;      // 4 warps, f32 kernel
constexpr int kTileQF32 = 16;      // query rows per block, f32 kernel
constexpr int kBlockK = 128;       // keys per K/V tile (the reference's)
constexpr int kHeadDimBf16 = 64;   // D of the bf16 kernel
// bf16 kernel
constexpr int kTileQ = 128;              // query rows a CTA
constexpr int kConsumerWarps = 8;        // two warpgroups of 64 rows
constexpr int kThreadsBf16 = 32 * kConsumerWarps;
constexpr int kStages = 2;               // K/V ring
constexpr int kCtasPerSm = 2;            // 2 x 82 KB of shared memory
// Causal scans differ in length (query tile i scans i + 1 key tiles), so
// the kernel launches the longest first across 48 (b, h) pairs at a time,
// which evens out the CTAs' ends; the group's K and V (12 MB at T = 1024)
// stay in L2. Without the causal stop every tile scans alike, and the
// tiles of one (b, h) run together (a group of 1). Of the group sizes
// tried on an H100 (16, 32, 48, 64, 96, 144), 48 was the fastest at
// GPT-2's causal shape; ablate_flash.py times the launch by (b, h).
constexpr int kCausalGroup = 48;
constexpr uint32_t kTileBytes = 128 * kHeadDimBf16 * 2;  // a 128 x 64 tile
// Q, kStages K and V tiles, the barriers, and room to align to 1024 bytes
constexpr int kSmemBf16 =
    (1 + 2 * kStages) * kTileBytes + 8 * (1 + 3 * kStages) + 1024;
constexpr int kErrNoEncoder = 10001;
constexpr int kErrTensorMap = 10002;

struct Strides {
  long long b, t, h;  // in elements; the last dim has stride 1
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Hopper primitives: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The wgmma descriptor of a tile that TMA wrote with the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (the stride along M/N
// for a K-major operand, along K for an MN-major one; the other offset is
// unused at these widths), tile base 1024-byte aligned. Advancing the
// start address by 32 bytes steps a K-major operand by 16 elements.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t kGroup = 1024 >> 4;  // in 16-byte units
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (kGroup << 16) |
         (kGroup << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

// Pins registers that an asynchronous wgmma reads or writes to this point
// of the program, so that the compiler moves no use of them across it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// The two row maxima of an m64n128 accumulator fragment (row g: the
// elements 4i and 4i + 1; row g + 8: 4i + 2 and 4i + 3) in four
// independent chains each, for the latency.
__device__ __forceinline__ void row_max(const float (&s)[64],
                                        float (&out)[2]) {
  auto f = [](float a, float b) { return fmaxf(a, b); };
  float t[8];  // row g: t[0..3]; row g + 8: t[4..7]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    t[i] = f(s[4 * i], s[4 * i + 1]);
    t[4 + i] = f(s[4 * i + 2], s[4 * i + 3]);
  }
#pragma unroll
  for (int i = 4; i < 16; ++i) {
    t[i & 3] = f(t[i & 3], f(s[4 * i], s[4 * i + 1]));
    t[4 + (i & 3)] = f(t[4 + (i & 3)], f(s[4 * i + 2], s[4 * i + 3]));
  }
  out[0] = f(f(t[0], t[1]), f(t[2], t[3]));
  out[1] = f(f(t[4], t[5]), f(t[6], t[7]));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p = 2^(s·scale·log2 e − m) for n-tiles [LO, HI) of the S tile in sc:
// each row's p summed into four chains of t (row g: t[0..3], row g + 8:
// t[4..7]) and packed to bf16 as the A fragments of P·V (k-slice ks of P
// is n-tiles 2ks and 2ks + 1: pa[4ks .. 4ks + 3]).
template <int LO, int HI>
__device__ __forceinline__ void exp_pack(const float (&sc)[64],
                                         uint32_t (&pa)[32], float (&t)[8],
                                         const float (&m)[2],
                                         float scale_log2) {
#pragma unroll
  for (int i = LO; i < HI; ++i) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = ex2(fmaf(sc[4 * i + e], scale_log2, -m[e >> 1]));
      t[(e >> 1) * 4 + (i & 3)] += p[e];
    }
    pa[2 * i] = pack_bf16(p[0], p[1]);
    pa[2 * i + 1] = pack_bf16(p[2], p[3]);
  }
}

// S (64 x 128, f32) = A · Bᵀ over one 16-wide k-slice, A and B both K-major
// in shared memory; scale_d = 0 overwrites S, 1 accumulates.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// O (64 x 64, f32) += P · V over one 16-key slice: P from registers (the
// bf16 A fragments a[0..3]), V from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t* a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---------------------------------------------------------------------------
// bf16: TMA loads and wgmma products (see the header)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreadsBf16, kCtasPerSm)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, int T, int H,
                   Strides so, float scale_log2, int causal) {
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes; the wgmma descriptors
  // assume tiles aligned to it
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + kTileBytes;                // kStages tiles
  const uint32_t sV = sK + kStages * kTileBytes;        // kStages tiles
  const uint32_t bars = sV + kStages * kTileBytes;
  const uint32_t bar_q = bars;
  auto full_k = [&](int s) { return bars + 8u * (1 + s); };
  auto full_v = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };

  // launch order: (b, h) pairs in groups of `group`, and within a group
  // the query tiles by position, the last first; the group's K and V stay
  // in L2 while its tiles run (see kCausalGroup)
  const int n_qt = T / kTileQ;
  const int group = causal ? kCausalGroup : 1;
  const int n_bh = static_cast<int>(gridDim.x) / n_qt;
  const int grp = static_cast<int>(blockIdx.x) / (group * n_qt);
  const int rem = static_cast<int>(blockIdx.x) % (group * n_qt);
  const int size = min(group, n_bh - grp * group);
  const int qi = n_qt - 1 - rem / size;
  const int bh = grp * group + rem % size;
  const int b = bh / H, h = bh % H;
  const int q0 = qi * kTileQ;
  const int nk = causal ? qi + 1 : T / kBlockK;  // kTileQ == kBlockK
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // warpgroup wg owns tile rows [64 wg, 64 wg + 64); this thread rows r0
  // and r0 + 8 of them (the wgmma accumulator layout). Tile j: S by
  // wgmma, the softmax in registers, O += P·V by wgmma.
  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int r0 = wg * 64 + (warp & 3) * 16 + g;
  const uint64_t desc_q = smem_desc(sQ + wg * 64 * 128);
  float acc[32], sc[64];  // O; S of n-tile i (keys 8i..8i+7) in sc[4i..]
  uint32_t pa[32];        // P as bf16 A fragments: k-slice ks in pa[4ks..]
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // m in base 2
  auto issue_s = [&](int j) {
    const uint64_t desc_k = smem_desc(sK + (j % kStages) * kTileBytes);
#pragma unroll
    for (int kk = 0; kk < kHeadDimBf16 / 16; ++kk)
      wgmma_qk(sc, desc_q + 2 * kk, desc_k + 2 * kk, kk);
  };
  auto issue_pv = [&](int j, int ks0) {  // k-slices ks0 .. ks0 + 3
    const uint64_t desc_v = smem_desc(sV + (j % kStages) * kTileBytes);
#pragma unroll
    for (int ks = ks0; ks < ks0 + 4; ++ks)  // 16 keys = 2048 bytes
      wgmma_pv(acc, pa + 4 * ks, desc_v + 128 * ks);
  };
  auto wait_products = [&] {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_regs(acc);
    fence_regs(pa);
    fence_regs(sc);
  };
  auto release = [&](int j) {  // this warp is done with tile j's stage
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(j % kStages));
  };
  // thread 0 issues every TMA load: Q and the first kStages K/V tiles at
  // once, tile j + kStages - 1 at step j once both warpgroups have
  // released tile j - 1 from its stage
  auto load_kv = [&](int j) {
    const int s = j % kStages;
    mbar_expect_tx(full_k(s), kTileBytes);
    tma_load(sK + s * kTileBytes, &tk, full_k(s), 0, h, j * kBlockK, b);
    mbar_expect_tx(full_v(s), kTileBytes);
    tma_load(sV + s * kTileBytes, &tv, full_v(s), 0, h, j * kBlockK, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, kTileBytes);
    tma_load(sQ, &tq, bar_q, 0, h, q0, b);
    for (int j = 0; j < kStages && j < nk; ++j) load_kv(j);
  }
  mbar_wait(bar_q, 0);
  for (int j = 0; j < nk; ++j) {
    const uint32_t parity = (j / kStages) & 1;
    const int next = j + kStages - 1;
    if (threadIdx.x == 0 && j > 0 && next < nk) {
      mbar_wait(empty(next % kStages), ((j - 1) / kStages) & 1);
      load_kv(next);
    }
    mbar_wait(full_k(j % kStages), parity);
    fence_regs(sc);
    wgmma_fence();
    issue_s(j);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    wait_products();

    // the online softmax in base 2: row max of the raw scores (the scale
    // is positive), running max m, correction of l and O
    if (causal && j == nk - 1) {  // the diagonal tile: key c <= row r
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i * 8 + 2 * t4 + (e & 1) > r0 + 8 * (e >> 1))
            sc[4 * i + e] = kNegInf;
    }
    float mx[2], corr[2];
    row_max(sc, mx);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= corr[(i >> 1) & 1];
    // P of keys 0..63, then its half of P·V runs on the tensor cores
    // while P of keys 64..127 is computed
    float t[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    exp_pack<0, 8>(sc, pa, t, m, scale_log2);
    mbar_wait(full_v(j % kStages), parity);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
    issue_pv(j, 0);
    exp_pack<8, 16>(sc, pa, t, m, scale_log2);
    fence_regs(pa);
    wgmma_fence();
    issue_pv(j, 4);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = (t[4 * r] + t[4 * r + 1]) + (t[4 * r + 2] + t[4 * r + 3]);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * corr[r] + sum;
    }
    wait_products();
    release(j);
  }

  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / (l[r] > 0.f ? l[r] : 1.f);
    __nv_bfloat16* orow = ob + (q0 + r0 + 8 * r) * so.t + 2 * t4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8) =
          __floats2bfloat162_rn(acc[4 * i + 2 * r] * inv,
                                acc[4 * i + 2 * r + 1] * inv);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// float32: 4 warps per 16-row query tile, 4 rows a warp. Scores: lane L
// takes keys L, L + 32, ...; P·V: lane L takes columns L, L + 32, ...
// (D <= 128).
template <int BK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int T,
                  int H, int BH, int D, Strides sq, Strides sk, Strides sv,
                  Strides so, float scale, int causal) {
  constexpr int KPL = (BK + 31) / 32;  // keys a lane scores
  constexpr int RPW = kTileQF32 / 4;   // query rows a warp owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kTileQF32 * D;      // row stride D + 1: lane per key
  float* sV = sK + BK * (D + 1);

  const int n_qt = (T + kTileQF32 - 1) / kTileQF32;
  const int qi = n_qt - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / H, h = bh % H;
  const int q0 = qi * kTileQF32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  for (int e = threadIdx.x; e < kTileQF32 * D; e += kThreads) {
    const int r = e / D, c = e % D;
    sQ[e] = q0 + r < T ? qb[(q0 + r) * sq.t + c] : 0.f;
  }
  float m[RPW], l[RPW], acc[RPW][4];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) acc[i][dd] = 0.f;
  }
  const int last = min(q0 + kTileQF32, T) - 1;
  const int nk = causal ? last / BK + 1 : T / BK;
  for (int j = 0; j < nk; ++j) {
    const int kb0 = j * BK;
    __syncthreads();
    for (int e = threadIdx.x; e < BK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      sK[r * (D + 1) + c] = kb[(kb0 + r) * sk.t + c];
      sV[e] = vb[(kb0 + r) * sv.t + c];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      const int row = q0 + r;
      float s[KPL];
      float mx = kNegInf;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        const int key = lane + 32 * kk;
        s[kk] = -INFINITY;  // lanes past BK: no key
        if (key < BK) {
          const float* kr = sK + key * (D + 1);
          const float* qr = sQ + r * D;
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
          float val = dot * scale;
          if (causal && row < kb0 + key) val = kNegInf;
          s[kk] = val;
          mx = fmaxf(mx, val);
        }
      }
      const float m_new = fmaxf(m[i], warp_max(mx));
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        s[kk] = expf(s[kk] - m_new);  // exp(-inf) = 0 past BK
        psum += s[kk];
      }
      l[i] = l[i] * corr + warp_sum(psum);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) acc[i][dd] *= corr;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        for (int src = 0; src < 32; ++src) {
          const int key = kk * 32 + src;
          const float p = __shfl_sync(0xffffffffu, s[kk], src);
          if (key >= BK) break;
          const float* vr = sV + key * D;
#pragma unroll
          for (int dd = 0; dd < 4; ++dd) {
            const int d = lane + 32 * dd;
            if (d < D) acc[i][dd] += p * vr[d];
          }
        }
      }
    }
  }
  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = q0 + warp * RPW + i;
    if (row >= T) continue;
    const float denom = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const int d = lane + 32 * dd;
      if (d < D) ob[row * so.t + d] = acc[i][dd] / denom;
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime, so that
// the library needs no link against libcuda.
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of one bf16 [B, T, H, 64] operand at element strides st:
// boxes of 128 rows along T of one (b, h), 128-byte swizzled.
int encode(CUtensorMap* map, const void* ptr, int B, int T, int H,
           const Strides& st) {
  const EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {kHeadDimBf16, static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.t) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {kHeadDimBf16, 1, kBlockK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int T, int H, const Strides* st, float scale, int causal,
                cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  int rc = encode(&tq, q, B, T, H, st[0]);
  if (rc == 0) rc = encode(&tk, k, B, T, H, st[1]);
  if (rc == 0) rc = encode(&tv, v, B, T, H, st[2]);
  if (rc != 0) return rc;
  cudaError_t err = set_smem(flash_fwd_bf16, kSmemBf16);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 =
      static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  const long long blocks = static_cast<long long>(T / kTileQ) * B * H;
  flash_fwd_bf16<<<static_cast<unsigned>(blocks), kThreadsBf16, kSmemBf16,
                   s>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), T, H,
                        st[3], scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int BK>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int T, int H, int D, const Strides* st, float scale,
               int causal, cudaStream_t s) {
  const size_t smem =
      (kTileQF32 * D + BK * (D + 1) + BK * D) * sizeof(float);
  auto kernel = flash_fwd_f32<BK>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int BH = B * H;
  const long long blocks =
      static_cast<long long>((T + kTileQF32 - 1) / kTileQF32) * BH;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), T, H, BH, D,
      st[0], st[1], st[2], st[3], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, o: [B, T, H, D] with the last dim contiguous; strides holds 12
// element strides, (b, t, h) of q, k, v, o in that order. bf16 (is_bf16):
// D = kHeadDimBf16, scale > 0, q, k and v 16-byte aligned with strides of
// a multiple of 16 bytes (TMA's conditions). f32: D <= 128. block_k =
// kBlockK and T % block_k == 0: one instance per dtype, those that
// chip_smoke.py holds against the plain version (the full-size models of
// the repo all have head dim 64); other shapes are refused.
// Launches on `stream`, does not synchronise; returns a cudaError_t (0 on
// success) or one of the kErr codes.
int flash_attn_fwd_launch(const void* q, const void* k, const void* v,
                          void* o, int B, int T, int H, int D,
                          const long long* strides, float scale, int causal,
                          int block_k, int is_bf16, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || block_k != kBlockK || T % block_k != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D != kHeadDimBf16 || !(scale > 0.f))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_bf16(q, k, v, o, B, T, H, st, scale, causal, s);
  }
  if (D <= 0 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  return launch_f32<kBlockK>(q, k, v, o, B, T, H, D, st, scale, causal, s);
}

const char* flash_attn_fwd_error_string(int code) {
  if (code == kErrNoEncoder)
    return "cuTensorMapEncodeTiled not found in the driver";
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
