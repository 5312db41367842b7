// Analog-array contractions with ADC partial-sum quantisation on Hopper
// CUDA cores: kernels K6 and K7.
//
// Replaces the Pallas TPU kernels repro/kernels/analog_matmul.py:
//   analog_matmul        (_kernel, _adc_quantize) -> analog_matmul()
//   analog_matmul_fused  (_fused_kernel)          -> analog_matmul_fused()
//
// What is computed: the unipolar product of x [M, 2K] with the plane
// [wa; wb] (two [K, N] halves, read in place), with the 2K ports cut into
// arrays of array_size.  Each array's partial sum is clamped to
// [0, adc_range], scaled to 2^adc_bits - 1 levels, rounded half to even,
// scaled back and min'd with adc_range; the quantised partial sums are added
// in float32, array by array in order.  The fused kernel does this for both
// polarities, w_pos = [wp; wn] and w_neg = [wn; wp], subtracts the two sums
// (sum(adc_p) - sum(adc_n), not sum(adc_p - adc_n)), rescales, casts and runs
// the epilogue.
//
// Exactness.  The emulator feeds bf16 operands in [0, 1] that sit on grids of
// at most 8 bits (fake_quant_unipolar): every nonzero operand is at least
// ~2^-9, so a product of two is a multiple of 2^-32 below 1, and a sum of 128
// such products is a multiple of 2^-32 below 2^7, which float64 holds
// exactly.  Each array's partial sum is therefore accumulated with float64
// FMAs, in any order, and rounded once to float32: its value does not depend
// on the order, tile or thread that computed it, and the kernels are bitwise
// equal to their plain versions (a float64 matmul per array).  The ADC then
// rounds every op as written (__fdiv_rn, __fmul_rn, rintf, fminf): no
// multiply-add is contracted, so a level decision cannot move by an ulp.
// No TF32 and no tensor cores: a partial sum that crosses an ADC level would
// change the result.
//
// What bounds it on this card: the bytes of the two bf16 weight planes at
// decode (M = 4); at prefill (M = 64) the float64 FMAs on the CUDA cores.
//
// What the design does about it: each thread owns a TM x TN tile of outputs
// and keeps its partial sums in float64 registers through one array, then
// quantises them and adds them to float32 accumulators.  The arrays must be
// summed in order, so when the output tiles alone cannot fill the SMs
// (decode) the arrays are split across blocks that store each array's
// quantised partial sums; a second pass adds them in array order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "epilogue.cuh"

// Named so a profiler trace attributes every kernel of this file, its
// finishing passes included, to it.
namespace repro_analog {
namespace {

struct Adc {
  float range;   // adc_range
  float levels;  // 2^adc_bits - 1
};

// repro/kernels/analog_matmul.py::_adc_quantize, one rounding per op.
__device__ __forceinline__ float adc_quantize(float psum, Adc a) {
  const float c = fminf(fmaxf(psum, 0.0f), a.range);
  float t = __fmul_rn(__fdiv_rn(c, a.range), a.levels);
  t = rintf(t);  // half to even, as jnp.round
  t = __fmul_rn(__fdiv_rn(t, a.levels), a.range);
  return fminf(t, a.range);
}

// Row gk of the plane [top; bottom] (K rows each), element n.
template <typename T>
__device__ __forceinline__ float plane(const T* top, const T* bottom, int gk, int K, int N,
                                       int n) {
  return gk < K ? repro_epi::load<T>(top, (size_t)gk * N + n)
                : repro_epi::load<T>(bottom, (size_t)(gk - K) * N + n);
}

// Blocks along z take arrays [z * per_split, (z + 1) * per_split).  With one
// split, the float32 sums go to sum_p (and sum_n); with more, each array's
// quantised partial sums go to q_p[c] (and q_n[c]), [M, N] each.
template <bool DUAL, typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    contract(const T* __restrict__ x, const T* __restrict__ wa, const T* __restrict__ wb,
             float* __restrict__ sum_p, float* __restrict__ sum_n, float* __restrict__ q_p,
             float* __restrict__ q_n, int M, int N, int K, int A, int per_split, Adc adc) {
  constexpr int TX = BN / TN;
  constexpr int NT = (BM / TM) * TX;
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];
  __shared__ float wn[DUAL ? BK : 1][BN];

  const int P = 2 * K;
  const int C = (P + A - 1) / A;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int c_begin = blockIdx.z * per_split;
  const int c_end = min(C, c_begin + per_split);
  const bool split = gridDim.z > 1;
  const size_t MN = (size_t)M * N;

  float ap[TM][TN], an[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) ap[i][j] = an[i][j] = 0.0f;

  for (int c = c_begin; c < c_end; ++c) {
    const int kb = c * A, ke = min(P, kb + A);
    double sp[TM][TN], sn[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sp[i][j] = sn[i][j] = 0.0;

    for (int k0 = kb; k0 < ke; k0 += BK) {
      for (int i = tid; i < BK * BM; i += NT) {
        const int kk = i / BM, mm = i % BM;
        const int gk = k0 + kk, gm = m0 + mm;
        xs[kk][mm] = (gk < ke && gm < M) ? repro_epi::load<T>(x, (size_t)gm * P + gk) : 0.0f;
      }
      for (int i = tid; i < BK * BN; i += NT) {
        const int kk = i / BN, nn = i % BN;
        const int gk = k0 + kk, gn = n0 + nn;
        const bool ok = gk < ke && gn < N;
        ws[kk][nn] = ok ? plane(wa, wb, gk, K, N, gn) : 0.0f;
        if constexpr (DUAL) wn[kk][nn] = ok ? plane(wb, wa, gk, K, N, gn) : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        double xv[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) xv[i] = (double)xs[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const double wv = (double)ws[kk][tx + j * TX];
#pragma unroll
          for (int i = 0; i < TM; ++i) sp[i][j] = fma(xv[i], wv, sp[i][j]);
          if constexpr (DUAL) {
            const double vv = (double)wn[kk][tx + j * TX];
#pragma unroll
            for (int i = 0; i < TM; ++i) sn[i][j] = fma(xv[i], vv, sn[i][j]);
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty * TM + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gn = n0 + tx + j * TX;
        const float qp = adc_quantize(__double2float_rn(sp[i][j]), adc);
        const float qn = DUAL ? adc_quantize(__double2float_rn(sn[i][j]), adc) : 0.0f;
        if (split) {
          if (gm < M && gn < N) {
            const size_t o = (size_t)c * MN + (size_t)gm * N + gn;
            q_p[o] = qp;
            if constexpr (DUAL) q_n[o] = qn;
          }
        } else {
          ap[i][j] = __fadd_rn(ap[i][j], qp);
          if constexpr (DUAL) an[i][j] = __fadd_rn(an[i][j], qn);
        }
      }
    }
  }

  if (split) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn >= N) continue;
      sum_p[(size_t)gm * N + gn] = ap[i][j];
      if constexpr (DUAL) sum_n[(size_t)gm * N + gn] = an[i][j];
    }
  }
}

// sum[i] = q[0][i] + q[1][i] + ... in array order, in float32.
__global__ void sum_arrays(const float* __restrict__ q, int C, size_t n, float* __restrict__ sum) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int c = 0; c < C; ++c) s = __fadd_rn(s, q[(size_t)c * n + i]);
    sum[i] = s;
  }
}

// Tile shapes and the array split: both the launch and the scratch size the
// caller allocates are derived here.
struct Plan {
  int bm, bn, gx, gy, per_split, splits, C;
};

Plan plan(int M, int N, int K, int A) {
  Plan p;
  p.bm = M <= 4 ? 4 : 64;
  p.bn = 128;
  p.gx = (N + p.bn - 1) / p.bn;
  p.gy = (M + p.bm - 1) / p.bm;
  p.C = (2 * K + A - 1) / A;
  const int tiles = p.gx * p.gy;
  const int want = (2 * repro_epi::sm_count() + tiles - 1) / tiles;
  const int parts = std::min(p.C, std::max(1, want));
  p.per_split = (p.C + parts - 1) / parts;
  p.splits = (p.C + p.per_split - 1) / p.per_split;
  return p;
}

template <bool DUAL, typename T>
void run(const void* x, const void* wa, const void* wb, float* sum_p, float* sum_n, float* q,
         int M, int N, int K, int A, Adc adc, cudaStream_t st) {
  const Plan p = plan(M, N, K, A);
  const size_t MN = (size_t)M * N;
  float* q_p = p.splits > 1 ? q : nullptr;
  float* q_n = p.splits > 1 && DUAL ? q + (size_t)p.C * MN : nullptr;
  const T* xt = static_cast<const T*>(x);
  const T* a = static_cast<const T*>(wa);
  const T* b = static_cast<const T*>(wb);
  const dim3 grid(p.gx, p.gy, p.splits);
  if (p.bm == 4)
    contract<DUAL, T, 4, 128, 16, 4, 1><<<grid, 128, 0, st>>>(xt, a, b, sum_p, sum_n, q_p, q_n, M,
                                                             N, K, A, p.per_split, adc);
  else
    contract<DUAL, T, 64, 128, 16, 4, 4><<<grid, 512, 0, st>>>(xt, a, b, sum_p, sum_n, q_p, q_n,
                                                              M, N, K, A, p.per_split, adc);
  if (p.splits > 1) {
    sum_arrays<<<repro_epi::grid_for(MN, 256), 256, 0, st>>>(q_p, p.C, MN, sum_p);
    if (DUAL) sum_arrays<<<repro_epi::grid_for(MN, 256), 256, 0, st>>>(q_n, p.C, MN, sum_n);
  }
}

// K7's value before the epilogue: (sum_p - sum_n) times the row's
// prescale, rounded to the output type.
template <typename T>
struct PlaneDifference {
  const float* sum_p;
  const float* sum_n;
  const float* pre;
  __device__ float operator()(size_t i, int m) const {
    return repro_epi::rnd<T>(__fmul_rn(__fsub_rn(sum_p[i], sum_n[i]), pre[m]));
  }
};

Adc make_adc(int adc_bits, float adc_range) { return Adc{adc_range, (float)((1 << adc_bits) - 1)}; }

}  // namespace
}  // namespace repro_analog

using namespace repro_analog;

// Floats of the array scratch q that K6 (dual = 0) or K7 (dual = 1) needs
// at this shape; 0 when the arrays are not split across blocks.
extern "C" int analog_scratch_floats(int M, int N, int K, int array_size, int dual) {
  const Plan p = plan(M, N, K, array_size);
  if (p.splits == 1) return 0;
  const size_t n = (size_t)p.C * M * N * (dual ? 2 : 1);
  return n > 0x7fffffff ? -1 : (int)n;
}

// K6: out[M,N] (float32) = sum over arrays of adc(x[m, array] . [wa; wb][array, n]).
// x [M, 2K], wa, wb [K, N]: float32 or bfloat16.  q: analog_scratch_floats().
extern "C" int analog_matmul(int in_bf16, const void* x, const void* wa, const void* wb, float* q,
                             float* out, int M, int N, int K, int array_size, int adc_bits,
                             float adc_range, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Adc adc = make_adc(adc_bits, adc_range);
  if (in_bf16)
    run<false, __nv_bfloat16>(x, wa, wb, out, nullptr, q, M, N, K, array_size, adc, st);
  else
    run<false, float>(x, wa, wb, out, nullptr, q, M, N, K, array_size, adc, st);
  return (int)cudaGetLastError();
}

// K7: both polarities, w_pos = [wp; wn] and w_neg = [wn; wp], then
// ((sum_p - sum_n) * pre[m]) cast to the output type, then the epilogue as
// in K2.  sums: float32 [2, M, N] scratch; q: analog_scratch_floats().
extern "C" int analog_matmul_fused(int in_bf16, int out_bf16, const void* x, const void* wp,
                                   const void* wn, float* q, float* sums, const float* pre,
                                   const void* gain, const void* add, const float* coeffs, int P,
                                   float mean_scale, float eps, void* out, int M, int N, int K,
                                   int array_size, int adc_bits, float adc_range, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Adc adc = make_adc(adc_bits, adc_range);
  float* sum_p = sums;
  float* sum_n = sums + (size_t)M * N;
  if (in_bf16)
    run<true, __nv_bfloat16>(x, wp, wn, sum_p, sum_n, q, M, N, K, array_size, adc, st);
  else
    run<true, float>(x, wp, wn, sum_p, sum_n, q, M, N, K, array_size, adc, st);
  if (out_bf16)
    repro_epi::finish<__nv_bfloat16>(PlaneDifference<__nv_bfloat16>{sum_p, sum_n, pre}, gain,
                                     add, coeffs, P, mean_scale, eps, out, M, N, st);
  else
    repro_epi::finish<float>(PlaneDifference<float>{sum_p, sum_n, pre}, gain, add, coeffs, P,
                             mean_scale, eps, out, M, N, st);
  return (int)cudaGetLastError();
}

extern "C" const char* analog_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
