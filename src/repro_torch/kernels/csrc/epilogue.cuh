// MODEL-mode epilogue as device functions: the CUDA counterpart of
// repro_torch/kernels/epilogue.py (and of repro/kernels/epilogue.py, whose
// apply_epilogue the Pallas fused kernels run in-register), and the
// finishing passes that apply it for the fused kernels K2, K5 and K7.
//
// Every operation runs in the output dtype and rounds to it after each op,
// exactly as the plain PyTorch epilogue does.  Products and sums use the
// _rn intrinsics, which nvcc never contracts into an FMA, so the kernel's
// rounding matches the plain version's op for op.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>
#include <utility>

namespace repro_epi {

// Round a float to the storage type T and back (identity for float).
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T> __device__ __forceinline__ float load(const T* p, size_t i);
template <> __device__ __forceinline__ float load<float>(const float* p, size_t i) {
  return p[i];
}
template <> __device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p,
                                                                 size_t i) {
  return __bfloat162float(p[i]);
}

template <typename T> __device__ __forceinline__ void store(T* p, size_t i, float v);
template <> __device__ __forceinline__ void store<float>(float* p, size_t i, float v) {
  p[i] = v;
}
template <> __device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* p, size_t i,
                                                                 float v) {
  p[i] = __float2bfloat16_rn(v);
}

// t**i for i >= 1 in the multiplication order of jax.lax.integer_pow
// (square-and-multiply), so t**3 is t * (t*t).
__device__ __forceinline__ float ipow(float t, int i) {
  float acc = 0.0f;
  bool has = false;
  float x = t;
  while (i > 0) {
    if (i & 1) {
      acc = has ? __fmul_rn(acc, x) : x;
      has = true;
    }
    i >>= 1;
    if (i) x = __fmul_rn(x, x);
  }
  return acc;
}

// sum_i c[i] * t**i, term by term in order (float32 throughout).
__device__ __forceinline__ float eval_poly(const float* c, int P, float t) {
  float out = c[0];
  for (int i = 1; i < P; ++i) out = __fadd_rn(out, __fmul_rn(c[i], ipow(t, i)));
  return out;
}

// y - eval_poly(c, y / c[P]), with the polynomial rounded to T before the
// subtraction: c holds the P coefficients, then the fitted scale (a device
// operand, so a caller never reads it back to the host).
template <typename T>
__device__ __forceinline__ float correct(float y, const float* c, int P) {
  const float t = __fdiv_rn(y, c[P]);
  return rnd<T>(__fsub_rn(y, rnd<T>(eval_poly(c, P, t))));
}

// Chip term: y * g + a * scale (gain families) or y + a * scale (fault
// families, no gain vector).
template <typename T>
__device__ __forceinline__ float chip(float y, bool has_gain, float g, float a, float scale) {
  const float off = rnd<T>(__fmul_rn(a, scale));
  const float base = has_gain ? rnd<T>(__fmul_rn(y, g)) : y;
  return rnd<T>(__fadd_rn(base, off));
}

// Launch helpers shared by the kernels.
inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

inline int grid_for(size_t n, int threads) {
  size_t b = (n + threads - 1) / threads;
  return (int)(b < 8192 ? (b > 0 ? b : 1) : 8192);
}

// The finishing passes of a fused kernel.  V is a functor whose
// operator()(i, m) gives output i = m * N + n before the epilogue: the
// contraction's value times the row's prescale, rounded to T.  A functor
// with release(i) has it called after its last read of output i (K5 clears
// its accumulators there).

template <typename V, typename = void>
struct has_release : std::false_type {};
template <typename V>
struct has_release<V, std::void_t<decltype(std::declval<const V&>().release(std::size_t{}))>>
    : std::true_type {};

template <typename V>
__device__ __forceinline__ void release(const V& val, size_t i) {
  if constexpr (has_release<V>::value) val.release(i);
}

// Epilogue without chip terms: elementwise.
template <typename T, typename V>
__global__ void finish_elementwise(V val, const float* __restrict__ coeffs, int P,
                                   T* __restrict__ out, int M, int N) {
  const size_t n = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float y = val(i, (int)(i / N));
    release(val, i);
    if (P > 0) y = correct<T>(y, coeffs, P);
    store<T>(out, i, y);
  }
}

// Epilogue with chip terms: one block per row, row max first (a max is
// order-free, so the row scale is the same bits as the plain version's).
template <typename T, typename V>
__global__ void finish_rows(V val, const T* __restrict__ gain, const T* __restrict__ add,
                            const float* __restrict__ coeffs, int P, float eps,
                            T* __restrict__ out, int N) {
  __shared__ float red[32];
  const int m = blockIdx.x;
  const size_t row = (size_t)m * N;
  float mx = 0.0f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) mx = fmaxf(mx, fabsf(val(row + n, m)));
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x < 32) {
    mx = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (threadIdx.x == 0) red[0] = mx;
  }
  __syncthreads();
  const float scale = rnd<T>(fmaxf(red[0], eps));
  const bool has_gain = gain != nullptr;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float y = val(row + n, m);
    release(val, row + n);
    y = chip<T>(y, has_gain, has_gain ? load<T>(gain, n) : 0.0f, load<T>(add, n), scale);
    if (P > 0) y = correct<T>(y, coeffs, P);
    store<T>(out, row + n, y);
  }
}

// Launch the finishing pass: chip terms when add != NULL (gain may be NULL:
// fault family), then the correction polynomial when P > 0.
template <typename T, typename V>
void finish(V val, const void* gain, const void* add, const float* coeffs, int P,
            float eps, void* out, int M, int N, cudaStream_t st) {
  T* o = static_cast<T*>(out);
  if (add == nullptr) {
    finish_elementwise<T><<<grid_for((size_t)M * N, 256), 256, 0, st>>>(val, coeffs, P,
                                                                        o, M, N);
  } else {
    finish_rows<T><<<M, 512, 0, st>>>(val, static_cast<const T*>(gain),
                                      static_cast<const T*>(add), coeffs, P, eps, o,
                                      N);
  }
}

}  // namespace repro_epi
