// LayerNorm and RMSNorm forwards for Hopper (sm_90a).
//
// Replaces ray_tpu/ops/layernorm.py::_layernorm_kernel and
// ::_rmsnorm_kernel (launched by _layernorm_fwd_impl and
// _rmsnorm_fwd_impl). For each row of x [N, D] (bf16 or f32), in f32:
//     layernorm: mean = Σx/D, var = Σ(x − mean)²/D (two passes, as the
//                reference), y = (x − mean)·rsqrt(var + eps)·w + b
//     rmsnorm:   ms = Σx²/D, y = x·rsqrt(ms + eps)·w
// with w and b in x's dtype promoted to f32, and one cast to x's dtype at
// the store.
//
// Bound: bytes. One read and one write of x (2·N·D elements) against
// about 8 f32 operations per element, far below the card's ridge, so the
// least time is 2·N·D·sizeof(T) bytes at the memory rate.
//
// Design. The TPU kernel takes 256-row blocks into VMEM and falls back to
// one block when N is not a multiple of 256; that is TPU tiling, with
// nothing to port. Here one warp owns one row and kWarps rows share a
// block, so any N works. When D is a multiple of 8 (bf16) or 4 (f32) and
// every pointer is 16-byte aligned, each lane loads NP packs of 16 bytes
// (lane, lane + 32, ...) and keeps the whole row in registers (at
// D = 768 in bf16: 3 packs of 8 per lane): the mean is a warp-shuffle
// sum, the variance a second pass over the same registers, the store a
// third, so x is read from memory once. Otherwise (D ragged, or D beyond
// 8 packs a lane) a scalar path walks the row from memory three times.
// The xor-butterfly sums give every lane the same bits and nothing is
// atomic, so results are identical from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;     // rows per block, one warp each
constexpr int kMaxPacks = 8;  // 16-byte packs a lane keeps in registers

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One 16-byte pack of VEC = 16 / sizeof(T) elements.
template <typename T>
struct alignas(16) Pack {
  static constexpr int VEC = 16 / sizeof(T);
  T v[VEC];
};

template <typename T>
__device__ __forceinline__ void load_pack(const T* p, float* f) {
  const Pack<T> pk = *reinterpret_cast<const Pack<T>*>(p);
#pragma unroll
  for (int j = 0; j < Pack<T>::VEC; ++j) f[j] = to_f32(pk.v[j]);
}

template <typename T>
__device__ __forceinline__ void store_pack(T* p, const float* f) {
  Pack<T> pk;
#pragma unroll
  for (int j = 0; j < Pack<T>::VEC; ++j) pk.v[j] = from_f32<T>(f[j]);
  *reinterpret_cast<Pack<T>*>(p) = pk;
}

// Row in registers: lane owns packs lane + 32·i for i < NP.
template <typename T, int NP, bool RMS>
__global__ void __launch_bounds__(kWarps * 32)
    norm_packed(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ b, T* __restrict__ y, int64_t n, int d,
                float eps) {
  constexpr int VEC = Pack<T>::VEC;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (row >= n) return;
  const int packs = d / VEC;
  const T* xr = x + row * d;
  float v[NP][VEC];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = lane + 32 * i;
    if (p < packs) {
      load_pack(xr + p * VEC, v[i]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[i][j] = 0.f;
    }
  }
  float mean = 0.f;
  if (!RMS) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += v[i][j];
    mean = warp_sum(s) / d;
  }
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (lane + 32 * i < packs) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float c = v[i][j] - mean;
        q += c * c;
      }
    }
  }
  const float inv = 1.f / sqrtf(warp_sum(q) / d + eps);
  T* yr = y + row * d;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = lane + 32 * i;
    if (p >= packs) continue;
    float wf[VEC], out[VEC];
    load_pack(w + p * VEC, wf);
    if (RMS) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[j] = v[i][j] * inv * wf[j];
    } else {
      float bf[VEC];
      load_pack(b + p * VEC, bf);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        out[j] = (v[i][j] - mean) * inv * wf[j] + bf[j];
    }
    store_pack(yr + p * VEC, out);
  }
}

// Any D and alignment: three passes over the row from memory.
template <typename T, bool RMS>
__global__ void __launch_bounds__(kWarps * 32)
    norm_scalar(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ b, T* __restrict__ y, int64_t n, int d,
                float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (row >= n) return;
  const T* xr = x + row * d;
  float mean = 0.f;
  if (!RMS) {
    float s = 0.f;
    for (int j = lane; j < d; j += 32) s += to_f32(xr[j]);
    mean = warp_sum(s) / d;
  }
  float q = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float c = to_f32(xr[j]) - mean;
    q += c * c;
  }
  const float inv = 1.f / sqrtf(warp_sum(q) / d + eps);
  T* yr = y + row * d;
  for (int j = lane; j < d; j += 32) {
    const float yn = (to_f32(xr[j]) - mean) * inv * to_f32(w[j]);
    yr[j] = from_f32<T>(RMS ? yn : yn + to_f32(b[j]));
  }
}

template <typename T, bool RMS>
int launch(const void* x, const void* w, const void* b, void* y, int64_t n,
           int d, float eps, int packs, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  const dim3 block(kWarps * 32);
  const dim3 grid(static_cast<unsigned>((n + kWarps - 1) / kWarps));
  const int np = (packs + 31) / 32;
  if (packs == 0 || np > kMaxPacks) {
    norm_scalar<T, RMS><<<grid, block, 0, s>>>(xp, wp, bp, yp, n, d, eps);
    return static_cast<int>(cudaGetLastError());
  }
  switch (np) {
#define NORM_CASE(NP)                                                    \
  case NP:                                                               \
    norm_packed<T, NP, RMS><<<grid, block, 0, s>>>(xp, wp, bp, yp, n, d, \
                                                   eps);                 \
    break;
    NORM_CASE(1)
    NORM_CASE(2)
    NORM_CASE(3)
    NORM_CASE(4)
    NORM_CASE(5)
    NORM_CASE(6)
    NORM_CASE(7)
    NORM_CASE(8)
#undef NORM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool RMS>
int dispatch(const void* x, const void* w, const void* b, void* y,
             long long n, int d, float eps, int is_bf16, int packs,
             void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16, RMS>(x, w, b, y, n, d, eps, packs, s)
                 : launch<float, RMS>(x, w, b, y, n, d, eps, packs, s);
}

}  // namespace

extern "C" {

// x, y: [n, d] contiguous; w, b: [d], all of one dtype (bf16 if is_bf16,
// else f32). packs = d / (16 / sizeof(T)) when d is a multiple of that and
// every pointer is 16-byte aligned, else 0 (the scalar path). Launches on
// `stream`, does not synchronise, returns the cudaError_t of the launch.
int layernorm_launch(const void* x, const void* w, const void* b, void* y,
                     long long n, int d, float eps, int is_bf16, int packs,
                     void* stream) {
  return dispatch<false>(x, w, b, y, n, d, eps, is_bf16, packs, stream);
}

// As layernorm_launch; b is not read.
int rmsnorm_launch(const void* x, const void* w, const void* b, void* y,
                   long long n, int d, float eps, int is_bf16, int packs,
                   void* stream) {
  return dispatch<true>(x, w, b, y, n, d, eps, is_bf16, packs, stream);
}

const char* layernorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
