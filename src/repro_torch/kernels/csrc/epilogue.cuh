// MODEL-mode epilogue as device functions: the CUDA counterpart of
// repro_torch/kernels/epilogue.py (and of repro/kernels/epilogue.py, whose
// apply_epilogue the Pallas fused kernels run in-register).
//
// Every operation runs in the output dtype and rounds to it after each op,
// exactly as the plain PyTorch epilogue does.  Products and sums use the
// _rn intrinsics, which nvcc never contracts into an FMA, so the kernel's
// rounding matches the plain version's op for op.
#pragma once

#include <cuda_bf16.h>

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

// y - eval_poly(coeffs, y / mean_scale), with the polynomial rounded to T
// before the subtraction.
template <typename T>
__device__ __forceinline__ float correct(float y, const float* c, int P, float mean_scale) {
  const float t = __fdiv_rn(y, mean_scale);
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

}  // namespace repro_epi
