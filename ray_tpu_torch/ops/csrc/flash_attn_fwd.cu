// Flash-attention forward for Hopper (sm_90a).
//
// Replaces ray_tpu/ops/attention.py::_flash_kernel (launched by
// _flash_fwd_impl). For q, k, v of shape [B, T, H, D], and each (b, h),
// query row i:
//     s_j = (q_i · k_j) · scale, with s_j = -1e30 where causal and j > i
//     o_i = Σ_j softmax(s)_j · v_j
// computed as the reference does: K and V in blocks of BK keys, an online
// softmax with a running max m, denominator l and accumulator o in f32,
// the scan stopping at the last block a causal query tile can see, and
// o / l with an l > 0 guard at the end. In bf16, p is cast to bf16 before
// the p·V product (the reference's `p.astype(v.dtype)`), while l sums the
// f32 p.
//
// Bound. At GPT-2's shape (B·H = 144, T = 1024, D = 64, causal) the work
// is 4·D flops per visible (query, key) pair, about 19.5 GFLOP, and the
// bytes are one read of q, k, v and one write of o, 75.5 MB: 20 µs of
// bf16 tensor-core time against 22.5 µs of memory time. The kernel sits at
// the ridge, so a fast one needs both the tensor cores and full-rate
// loads; this first version is right and simple first.
//
// Design.
// - bf16 (flash_fwd_bf16): one block of 4 warps per (b·h, 64-row query
//   tile); each warp owns 16 query rows. The Q tile, then each K and V
//   tile, is copied to shared memory with 16-byte loads straight from the
//   caller's [B, T, H, D] strides (q, k, v may be views into one qkv
//   tensor: no transposes, no copies). S = Q·Kᵀ and O += P·V run on the
//   tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate): the
//   S accumulator fragments are rescaled, exponentiated and packed to
//   bf16 in registers and are directly the A operand of P·V; V's B
//   operand comes transposed from shared memory through ldmatrix.trans.
//   Rows of shared memory are padded by 8 elements so that the fragment
//   loads are free of bank conflicts. Row max and row sum need the 4
//   lanes that share a row (two xor shuffles). Query tiles are issued
//   from the last (the longest under the causal stop) to the first.
// - f32 (flash_fwd_f32): the same online softmax on the CUDA cores, for
//   float32 models: 4 warps per 16-row query tile, a lane per key for
//   the scores and a lane per output column for P·V.
// No atomics: every sum has a fixed order, so results are identical from
// run to run. BK is the reference's 128 and T must be a multiple of it
// (its flash route's condition, `_flash_aligned`, at T >= 128); the bf16
// kernel is built for D = 64 only, the head dim of every full-size model
// of the repo.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kThreads = 128;      // 4 warps
constexpr int kTileQ = 64;         // query rows per block, bf16 kernel
constexpr int kTileQF32 = 16;      // query rows per block, f32 kernel
constexpr int kBlockK = 128;       // keys per K/V tile (the reference's)
constexpr int kHeadDimBf16 = 64;   // D of the bf16 kernel

struct Strides {
  long long b, t, h;  // in elements; the last dim has stride 1
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copies `rows` rows of D bf16 from global (row stride `rs` elements,
// first row at `src`) into shared memory with row stride LDS, 16 bytes a
// thread; rows at or past `valid` are zero-filled.
template <int D, int LDS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long rs, int rows,
                                          int valid) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid)
      val = *reinterpret_cast<const uint4*>(src + r * rs + cc * 8);
    *reinterpret_cast<uint4*>(dst + r * LDS + cc * 8) = val;
  }
}

template <int D, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int T, int H, int BH,
                   Strides sq, Strides sk, Strides sv, Strides so,
                   float scale, int causal) {
  constexpr int LDS = D + 8;   // padded row, conflict-free fragments
  constexpr int NT = BK / 8;   // n-tiles of S
  constexpr int KD = D / 16;   // k-slices of Q·Kᵀ
  constexpr int ND = D / 8;    // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kTileQ * LDS;
  __nv_bfloat16* sV = sK + BK * LDS;

  const int n_qt = (T + kTileQ - 1) / kTileQ;
  const int qi = n_qt - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / H, h = bh % H;
  const int q0 = qi * kTileQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;

  load_tile<D, LDS>(sQ, qb + q0 * sq.t, sq.t, kTileQ, T - q0);
  __syncthreads();
  uint32_t qa[KD][4];
  {
    const __nv_bfloat16* r0 = sQ + (warp * 16 + g) * LDS + 2 * t4;
    const __nv_bfloat16* r1 = r0 + 8 * LDS;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      qa[ks][0] = lds32(r0 + ks * 16);
      qa[ks][1] = lds32(r1 + ks * 16);
      qa[ks][2] = lds32(r0 + ks * 16 + 8);
      qa[ks][3] = lds32(r1 + ks * 16 + 8);
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  const int last = min(q0 + kTileQ, T) - 1;
  const int nk = causal ? last / BK + 1 : T / BK;
  for (int j = 0; j < nk; ++j) {
    const int kb0 = j * BK;
    __syncthreads();  // every warp is done with the previous K, V tile
    load_tile<D, LDS>(sK, kb + kb0 * sk.t, sk.t, BK, BK);
    load_tile<D, LDS>(sV, vb + kb0 * sv.t, sv.t, BK, BK);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const __nv_bfloat16* kr = sK + (nt * 8 + g) * LDS + 2 * t4;
#pragma unroll
      for (int ks = 0; ks < KD; ++ks)
        mma_bf16(s[nt], qa[ks], lds32(kr + ks * 16), lds32(kr + ks * 16 + 8));
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[nt][e] * scale;
        const int col = kb0 + nt * 8 + 2 * t4 + (e & 1);
        if (causal && row[e >> 1] < col) val = kNegInf;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    // O += P·V: the S fragments of n-tiles 2ks and 2ks+1 are the A
    // operand of k-slice ks; ldmatrix.trans gives V's B operand for two
    // n-tiles of O at once.
    const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
      const __nv_bfloat16* vr =
          sV + (ks * 16 + (mat & 1) * 8 + mrow) * LDS + (mat >> 1) * 8;
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb4[4];
        ldmatrix_x4_trans(vb4, vr + dp * 16);
        mma_bf16(acc[2 * dp], pa, vb4[0], vb4[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb4[2], vb4[3]);
      }
    }
  }

  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    const float denom = l[r] > 0.f ? l[r] : 1.f;
    __nv_bfloat16* orow = ob + row[r] * so.t + 2 * t4;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      __nv_bfloat162 val = __floats2bfloat162_rn(acc[i][2 * r] / denom,
                                                 acc[i][2 * r + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8) = val;
    }
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

template <int D, int BK>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int T, int H, const Strides* st, float scale, int causal,
                cudaStream_t s) {
  const size_t smem = (kTileQ + 2 * BK) * (D + 8) * sizeof(__nv_bfloat16);
  auto kernel = flash_fwd_bf16<D, BK>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int BH = B * H;
  const long long blocks =
      static_cast<long long>((T + kTileQ - 1) / kTileQ) * BH;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      T, H, BH, st[0], st[1], st[2], st[3], scale, causal);
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
// D = kHeadDimBf16, every row 16-byte aligned. f32: D <= 128. block_k =
// kBlockK and T % block_k == 0: one instance per dtype, those that
// chip_smoke.py holds against the plain version (the full-size models of
// the repo all have head dim 64); other shapes are refused.
// Launches on `stream`, does not synchronise; returns a cudaError_t (0 on
// success).
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
    if (D != kHeadDimBf16) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bf16<kHeadDimBf16, kBlockK>(q, k, v, o, B, T, H, st, scale,
                                             causal, s);
  }
  if (D <= 0 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  return launch_f32<kBlockK>(q, k, v, o, B, T, H, D, st, scale, causal, s);
}

const char* flash_attn_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
