// Batchnorm-backward per-channel sums for Hopper (sm_90a).
//
// Replaces ray_tpu/ops/batchnorm.py::_sums_kernel (launched by
// _bn_bwd_sums). Given x and dy as [M, C] (bf16 or f32, C contiguous) and
// mean, inv as [C] f32, it computes in one read of x and dy:
//     sdy[c]  = sum_m dy[m, c]
//     sdyx[c] = sum_m dy[m, c] * (x[m, c] - mean[c]) * inv[c]
// both accumulated in f32.
//
// Bound: bytes. Each element costs 4 bytes of bf16 reads against ~5 f32
// operations, far below the card's ~20 operations per byte of f32 peak,
// so the least time is one read of x and dy at the memory rate.
//
// Design. The TPU kernel carries the sum along M in its output block,
// because its grid runs in order on one core. Here blocks run in parallel,
// so the sum is split in two stages and nothing carries between blocks:
//   1. partial_sums: the grid tiles (channel tile x M slab). Neighbouring
//      threads read neighbouring channels, VEC of them per 16-byte load,
//      so loads coalesce along C. Each thread walks its slab's rows with
//      a stride of blockDim.y and accumulates in registers; the block
//      folds its rows through shared memory in a fixed tree and writes one
//      partial row per slab to a [n_slabs, C] f32 scratch.
//   2. finalize: sums the partial rows over slabs, in a fixed split and a
//      fixed tree again.
// No atomics, so the result is bit-identical from run to run. The M split
// is what fills 132 SMs when C is small (C = 64 at ResNet-50's stem, where
// a channel-only grid would be one block). M and C are arbitrary: the
// kernel masks the ragged edge itself, so there is no fallback path.
// Launch geometry (VEC, threads per channel tile, slabs) is chosen by the
// Python wrapper, ray_tpu_torch/ops/batchnorm.py::_launch_geometry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // threads per block, both stages
constexpr int kFinalizeRows = 8;    // slab split of the finalize block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Folds s[ty][tx][v] over ty into s[0][tx][v]: a fixed tree, so the
// order of the additions never depends on timing.
template <int VEC>
__device__ __forceinline__ void fold_rows(float* s, int t, int ty, int tx_n,
                                          int ty_n) {
  for (int stride = ty_n / 2; stride > 0; stride >>= 1) {
    if (ty < stride) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) s[t * VEC + v] += s[(t + stride * tx_n) * VEC + v];
    }
    __syncthreads();
  }
}

// blockDim = (tx_n, ty_n) with tx_n * ty_n == kThreads, both powers of
// two. Block (bx, by) covers channels [bx * tx_n * VEC, +tx_n * VEC) over
// rows [by * rows_per_slab, +rows_per_slab).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    partial_sums(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ mean, const float* __restrict__ inv,
                 float* __restrict__ part_sdy, float* __restrict__ part_sdyx,
                 int64_t m, int c, int64_t rows_per_slab) {
  __shared__ float s_dy[kThreads * VEC];
  __shared__ float s_dyx[kThreads * VEC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tx_n = blockDim.x, ty_n = blockDim.y;
  const int t = ty * tx_n + tx;
  const int c0 = (blockIdx.x * tx_n + tx) * VEC;
  const bool active = c0 < c;  // VEC divides C, so a pack is all in or out
  const int64_t row_lo = static_cast<int64_t>(blockIdx.y) * rows_per_slab;
  const int64_t row_end = row_lo + rows_per_slab;
  const int64_t row_hi = row_end < m ? row_end : m;

  float acc_dy[VEC], acc_dyx[VEC], mu[VEC], iv[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    acc_dy[v] = 0.f;
    acc_dyx[v] = 0.f;
    mu[v] = active ? mean[c0 + v] : 0.f;
    iv[v] = active ? inv[c0 + v] : 0.f;
  }
  if (active) {
#pragma unroll 4
    for (int64_t r = row_lo + ty; r < row_hi; r += ty_n) {
      const int64_t off = r * c + c0;
      const Pack<T, VEC> xp = *reinterpret_cast<const Pack<T, VEC>*>(x + off);
      const Pack<T, VEC> dp = *reinterpret_cast<const Pack<T, VEC>*>(dy + off);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float d = to_f32(dp.v[v]);
        const float xhat = (to_f32(xp.v[v]) - mu[v]) * iv[v];
        acc_dy[v] += d;
        acc_dyx[v] += d * xhat;
      }
    }
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    s_dy[t * VEC + v] = acc_dy[v];
    s_dyx[t * VEC + v] = acc_dyx[v];
  }
  __syncthreads();
  fold_rows<VEC>(s_dy, t, ty, tx_n, ty_n);
  fold_rows<VEC>(s_dyx, t, ty, tx_n, ty_n);
  if (ty == 0 && active) {
    const int64_t out = static_cast<int64_t>(blockIdx.y) * c + c0;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      part_sdy[out + v] = s_dy[tx * VEC + v];
      part_sdyx[out + v] = s_dyx[tx * VEC + v];
    }
  }
}

// blockDim = (kThreads / kFinalizeRows, kFinalizeRows): threads in x take
// channels, threads in y take every kFinalizeRows-th slab.
__global__ void __launch_bounds__(kThreads)
    finalize(const float* __restrict__ part_sdy,
             const float* __restrict__ part_sdyx, float* __restrict__ sdy,
             float* __restrict__ sdyx, int n_slabs, int c) {
  __shared__ float s_dy[kThreads];
  __shared__ float s_dyx[kThreads];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tx_n = blockDim.x, ty_n = blockDim.y;
  const int t = ty * tx_n + tx;
  const int ch = blockIdx.x * tx_n + tx;
  float a = 0.f, b = 0.f;
  if (ch < c) {
    for (int s = ty; s < n_slabs; s += ty_n) {
      a += part_sdy[static_cast<int64_t>(s) * c + ch];
      b += part_sdyx[static_cast<int64_t>(s) * c + ch];
    }
  }
  s_dy[t] = a;
  s_dyx[t] = b;
  __syncthreads();
  fold_rows<1>(s_dy, t, ty, tx_n, ty_n);
  fold_rows<1>(s_dyx, t, ty, tx_n, ty_n);
  if (ty == 0 && ch < c) {
    sdy[ch] = s_dy[tx];
    sdyx[ch] = s_dyx[tx];
  }
}

template <typename T, int VEC>
void launch_partial(const void* x, const void* dy, const float* mean,
                    const float* inv, float* part_sdy, float* part_sdyx,
                    int64_t m, int c, int tx_n, int n_ctiles, int n_slabs,
                    int64_t rows_per_slab, cudaStream_t stream) {
  const dim3 block(tx_n, kThreads / tx_n);
  const dim3 grid(n_ctiles, n_slabs);
  partial_sums<T, VEC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, inv,
      part_sdy, part_sdyx, m, c, rows_per_slab);
}

}  // namespace

extern "C" {

// Launches both stages on `stream`. part_* are [n_slabs, C] f32 scratch,
// sdy/sdyx are [C] f32 outputs, all allocated by the caller. Returns the
// cudaError_t of the launches (0 on success); does not synchronise.
int bn_bwd_sums_launch(const void* x, const void* dy, const float* mean,
                       const float* inv, float* part_sdy, float* part_sdyx,
                       float* sdy, float* sdyx, long long m, int c,
                       int is_bf16, int vec, int tx_n, int n_ctiles,
                       int n_slabs, long long rows_per_slab, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && vec == 8) {
    launch_partial<__nv_bfloat16, 8>(x, dy, mean, inv, part_sdy, part_sdyx, m,
                                     c, tx_n, n_ctiles, n_slabs,
                                     rows_per_slab, s);
  } else if (is_bf16 && vec == 1) {
    launch_partial<__nv_bfloat16, 1>(x, dy, mean, inv, part_sdy, part_sdyx, m,
                                     c, tx_n, n_ctiles, n_slabs,
                                     rows_per_slab, s);
  } else if (!is_bf16 && vec == 4) {
    launch_partial<float, 4>(x, dy, mean, inv, part_sdy, part_sdyx, m, c,
                             tx_n, n_ctiles, n_slabs, rows_per_slab, s);
  } else if (!is_bf16 && vec == 1) {
    launch_partial<float, 1>(x, dy, mean, inv, part_sdy, part_sdyx, m, c,
                             tx_n, n_ctiles, n_slabs, rows_per_slab, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int fin_tx = kThreads / kFinalizeRows;
  const dim3 fin_block(fin_tx, kFinalizeRows);
  const dim3 fin_grid((c + fin_tx - 1) / fin_tx);
  finalize<<<fin_grid, fin_block, 0, s>>>(part_sdy, part_sdyx, sdy, sdyx,
                                          n_slabs, c);
  return static_cast<int>(cudaGetLastError());
}

const char* bn_bwd_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
