// Multiplier-error contractions on Hopper CUDA cores: kernels K1 and K2.
//
// Replaces the Pallas TPU kernels repro/kernels/vpu_matmul.py:
//   elementwise_matmul        (_kernel)        -> vpu_matmul()
//   elementwise_matmul_fused  (_fused_kernel)  -> vpu_matmul_fused()
// instantiated for the truncated multiplier (approx_mult.py) and the
// Mitchell logarithmic multiplier (log_matmul.py).
//
// What bounds it on this card: operations.  Every product passes through a
// nonlinear scalar multiplier, so tensor cores cannot be used; each product
// is 5-9 integer instructions on the CUDA cores, against 2-4 bytes of
// operand traffic per product that shared-memory reuse amortises away.
//
// What the design does about it:
// * Operands are integer-valued (the backends quantise them to at most
//   8 bits), so each product is computed in int32 arithmetic and summed in
//   an int32 accumulator: exact, hence independent of order, tile shape and
//   split-K.  floor(log2) comes from __clz, never from an approximate lg2.
//   The per-operand data the Mitchell product needs (sign * 2^floor(log2))
//   is computed once when a tile is staged, not once per product.
// * Each thread owns a TM x TN register tile and loops over K; x and w
//   tiles are staged in shared memory.  Small-M calls (decode, M = slots)
//   use a 4-row tile so no rows are wasted.
// * When the output tiles alone cannot fill the SMs (decode), K is split
//   across blocks that add into the int32 accumulator with atomics.
//   Integer addition is associative, so the result stays bitwise.
// * The Pallas fused kernel holds all of N in one tile so the epilogue's
//   row max is local.  Here a finishing kernel reads the int32 sums: an
//   elementwise pass when there are no chip terms (the serving engine's
//   case), else one block per row that takes the row max first.  A max is
//   order-free, so the result stays bitwise.
// * Ragged M, N and K are masked in the kernel (zero operands give zero
//   products for both multipliers); there is no padding copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "epilogue.cuh"

// Named so a profiler trace attributes every kernel of this file, its
// finishing passes included, to it.
namespace repro_vpu {
namespace {

constexpr int MUL_APPROX = 0;    // truncated product (approx_mult)
constexpr int MUL_MITCHELL = 1;  // Mitchell logarithmic product (log_mult)

// sign(v) * 2^floor(log2 |v|); 0 for v == 0.
__device__ __forceinline__ int signed_pow2(int v) {
  const int m = abs(v);
  if (m == 0) return 0;
  const int p = 1 << (31 - __clz(m));
  return v < 0 ? -p : p;
}

// One product through the multiplier.  a, b are the signed integer
// operands; pa, pb their signed_pow2 (used by Mitchell only).
template <int MUL>
__device__ __forceinline__ int product(int a, int pa, int b, int pb, int drop_bits) {
  if constexpr (MUL == MUL_APPROX) {
    // sign(ab) * floor(|ab| / 2^d) * 2^d: truncation toward zero
    const int p = a * b;
    const int s = p >> 31;  // 0 or -1
    const int mag = ((p ^ s) - s) & ~((1 << drop_bits) - 1);
    return (mag ^ s) - s;
  } else {
    // Mitchell, with |a| = 2^ka (1+ma), |b| = 2^kb (1+mb):
    //   m = ma + mb < 1:  |a| 2^kb + |b| 2^ka - 2^(ka+kb)
    //   otherwise:        2 (|a| 2^kb + |b| 2^ka) - 4 * 2^(ka+kb)
    // written with sign(ab) folded into S and T; the carry case is
    // |S| >= 3|T|, i.e. S - 3T is zero or has T's sign.
    const int S = a * pb + b * pa;
    const int T = pa * pb;
    const int d = S - 3 * T;
    return S - T + ((d ^ T) >= 0 ? d : 0);
  }
}

template <int MUL, typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    contract(const T* __restrict__ x, const T* __restrict__ w, int* __restrict__ acc, int M,
             int N, int K, int k_split, int drop_bits, int use_atomic) {
  constexpr int TX = BN / TN;  // threads along N
  constexpr int NT = (BM / TM) * TX;
  constexpr bool LOG = MUL == MUL_MITCHELL;
  __shared__ int xs[BK][BM + 1];
  __shared__ int xp[LOG ? BK : 1][BM + 1];
  __shared__ int ws[BK][BN];
  __shared__ int wp[LOG ? BK : 1][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_split;
  const int ke = min(K, kb + k_split);

  int a[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) a[i][j] = 0;

  for (int k0 = kb; k0 < ke; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int mm = i / BK, kk = i % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      int v = 0;
      if (gm < M && gk < ke) v = __float2int_rn(repro_epi::load<T>(x, (size_t)gm * K + gk));
      xs[kk][mm] = v;
      if constexpr (LOG) xp[kk][mm] = signed_pow2(v);
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, nn = i % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      int v = 0;
      if (gk < ke && gn < N) v = __float2int_rn(repro_epi::load<T>(w, (size_t)gk * N + gn));
      ws[kk][nn] = v;
      if constexpr (LOG) wp[kk][nn] = signed_pow2(v);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      int av[TM], ap[TM], bv[TN], bp[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        av[i] = xs[kk][ty * TM + i];
        ap[i] = 0;
        if constexpr (LOG) ap[i] = xp[kk][ty * TM + i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        bv[j] = ws[kk][tx + j * TX];
        bp[j] = 0;
        if constexpr (LOG) bp[j] = wp[kk][tx + j * TX];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) a[i][j] += product<MUL>(av[i], ap[i], bv[j], bp[j], drop_bits);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn >= N) continue;
      const size_t o = (size_t)gm * N + gn;
      if (use_atomic)
        atomicAdd(acc + o, a[i][j]);
      else
        acc[o] = a[i][j];
    }
  }
}

template <int MUL, typename T, int BM, int BN, int BK, int TM, int TN>
void run_contract(const T* x, const T* w, int* acc, int M, int N, int K, int drop_bits,
                  cudaStream_t st) {
  const int gx = (N + BN - 1) / BN, gy = (M + BM - 1) / BM;
  const int kblocks = (K + BK - 1) / BK;
  // split K until about two blocks per SM are in flight
  const int want = (2 * repro_epi::sm_count() + gx * gy - 1) / (gx * gy);
  const int parts = std::min(kblocks, std::max(1, want));
  const int k_split = ((kblocks + parts - 1) / parts) * BK;
  const int splits = (K + k_split - 1) / k_split;
  if (splits > 1) cudaMemsetAsync(acc, 0, (size_t)M * N * sizeof(int), st);
  contract<MUL, T, BM, BN, BK, TM, TN><<<dim3(gx, gy, splits), (BM / TM) * (BN / TN), 0, st>>>(
      x, w, acc, M, N, K, k_split, drop_bits, splits > 1);
}

template <int MUL, typename T>
void contract_any(const void* x, const void* w, int* acc, int M, int N, int K, int drop_bits,
                  cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  if (M <= 4)
    run_contract<MUL, T, 4, 256, 16, 4, 2>(xt, wt, acc, M, N, K, drop_bits, st);
  else
    run_contract<MUL, T, 32, 128, 16, 4, 4>(xt, wt, acc, M, N, K, drop_bits, st);
}

void contract_dispatch(int mul, int in_bf16, const void* x, const void* w, int* acc, int M,
                       int N, int K, int drop_bits, cudaStream_t st) {
  if (mul == MUL_APPROX) {
    if (in_bf16)
      contract_any<MUL_APPROX, __nv_bfloat16>(x, w, acc, M, N, K, drop_bits, st);
    else
      contract_any<MUL_APPROX, float>(x, w, acc, M, N, K, drop_bits, st);
  } else {
    if (in_bf16)
      contract_any<MUL_MITCHELL, __nv_bfloat16>(x, w, acc, M, N, K, drop_bits, st);
    else
      contract_any<MUL_MITCHELL, float>(x, w, acc, M, N, K, drop_bits, st);
  }
}

using repro_epi::grid_for;

__global__ void to_float(const int* __restrict__ acc, float* __restrict__ out, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = __int2float_rn(acc[i]);
}

// K2's value before the epilogue: the int32 sum times the row's prescale,
// rounded to the output type.
template <typename T>
struct ScaledSum {
  const int* acc;
  const float* pre;
  __device__ float operator()(size_t i, int m) const {
    return repro_epi::rnd<T>(__fmul_rn(__int2float_rn(acc[i]), pre[m]));
  }
};

}  // namespace
}  // namespace repro_vpu

using namespace repro_vpu;

// K1: out[M,N] (float32) = sum_k mul(x[m,k], w[k,n]).  x, w: integer-valued
// float32 or bfloat16, row-major; acc: int32 [M,N] scratch.
extern "C" int vpu_matmul(int mul, int in_bf16, const void* x, const void* w, int* acc,
                          float* out, int M, int N, int K, int drop_bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  contract_dispatch(mul, in_bf16, x, w, acc, M, N, K, drop_bits, st);
  to_float<<<grid_for((size_t)M * N, 256), 256, 0, st>>>(acc, out, (size_t)M * N);
  return (int)cudaGetLastError();
}

// K2: K1's contraction, then (acc * pre[m]) cast to the output type, then the
// epilogue: chip term when add != NULL (gain may be NULL: fault family), then
// the correction polynomial when P > 0.  gain/add are in the output type.
extern "C" int vpu_matmul_fused(int mul, int in_bf16, int out_bf16, const void* x, const void* w,
                                const float* pre, const void* gain, const void* add,
                                const float* coeffs, int P, float mean_scale, float eps, int* acc,
                                void* out, int M, int N, int K, int drop_bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  contract_dispatch(mul, in_bf16, x, w, acc, M, N, K, drop_bits, st);
  if (out_bf16)
    repro_epi::finish<__nv_bfloat16>(ScaledSum<__nv_bfloat16>{acc, pre}, gain, add, coeffs, P,
                                     mean_scale, eps, out, M, N, st);
  else
    repro_epi::finish<float>(ScaledSum<float>{acc, pre}, gain, add, coeffs, P, mean_scale, eps,
                             out, M, N, st);
  return (int)cudaGetLastError();
}

extern "C" const char* vpu_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
