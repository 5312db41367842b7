// Stochastic-computing contractions on Hopper CUDA cores: kernels K4 and K5.
//
// Replaces the Pallas TPU kernels repro/kernels/sc_matmul.py:
//   sc_matmul_packed        (_kernel)       -> sc_matmul(), sc_matmul_words()
//   sc_matmul_packed_fused  (_fused_kernel) -> sc_matmul_fused()
// together with the stream generation that repro/kernels/ops.py runs in
// front of them (ref.sc_pack_streams: bit j of a word is p > u_j, 32 bits
// per uint32 word, least significant bit first).
//
// What is computed: the split-unipolar plane [2K, N] is given as its two
// halves (rows 0..K-1 and K..2K-1), read in place.  Every probability
// becomes a bit-stream by comparing it with its port's generator sequence
// (activations: one sequence shared by all ports; weights: one per port
// row), products are the AND of two streams, accumulation is the OR over
// the 2K ports, and the result is popcount / bits.  The fused kernel
// accumulates both output polarities, w_pos = [wp; wn] and w_neg = [wn; wp],
// against the same streams, then subtracts, rescales, casts and runs the
// epilogue.
//
// What bounds it on this card: at decode (M = 4) the bytes of the two bf16
// weight planes; at prefill (M = 64) the AND/OR word operations, 2 per
// (row, port, column, word), on the CUDA cores.
//
// What the design does about it:
// * Weight streams are never written to memory.  A block stages a tile of
//   probabilities and builds their words in shared memory.  Materialising
//   them through plain torch would take a [.., 32] comparison tensor of
//   ~20 GB per plane at the lm_head.
// * A word is built with a binary search instead of 32 comparisons.  For
//   each (port, word) a table holds the 32 thresholds sorted ascending and
//   prefix masks mask[c] = OR of the stream bits of the c smallest.  A
//   probability p sets exactly the bits j with u_j < p, the c = #{u_j < p}
//   smallest, so its word is mask[c]: 6 comparisons, bitwise the same as
//   p > u_j bit by bit, ties and NaN included (both compare false).
// * Port k and port k + K read the same weight row (top half at k, bottom
//   half at k) against their own sequences, so each weight element is read
//   once per call: K4 builds 2 words from it, K5 4 (both polarities).
// * AND, OR and popcount do not depend on order, so tiles, split-K with
//   atomicOr and the word layout cannot change the result: K4 and K5 are
//   bitwise equal to their plain versions.  At decode the output tiles
//   alone cannot fill the SMs, so K is split across blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "epilogue.cuh"

// Named so a profiler trace attributes every kernel of this file, its
// finishing passes included, to it.
namespace repro_sc {
namespace {

constexpr int MAX_WORDS = 8;  // streams of at most 256 bits
constexpr int ROW = 65;       // table row: 32 sorted thresholds, 33 prefix masks

enum { SRC_PLANES = 0, SRC_PLANES_DUAL = 1, SRC_WORDS = 2 };

// One table row per (port, word): sort the word's 32 thresholds and record
// the prefix masks.  u holds rows of 32 floats.
__global__ void build_tables(const float* __restrict__ u, int rows, uint32_t* __restrict__ tab) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float s[32];
  int id[32];
  for (int j = 0; j < 32; ++j) {
    s[j] = u[(size_t)r * 32 + j];
    id[j] = j;
  }
  for (int i = 1; i < 32; ++i) {  // insertion sort, ascending
    const float v = s[i];
    const int t = id[i];
    int j = i - 1;
    while (j >= 0 && s[j] > v) {
      s[j + 1] = s[j];
      id[j + 1] = id[j];
      --j;
    }
    s[j + 1] = v;
    id[j + 1] = t;
  }
  uint32_t* row = tab + (size_t)r * ROW;
  uint32_t m = 0;
  row[32] = 0;
  for (int i = 0; i < 32; ++i) {
    row[i] = __float_as_uint(s[i]);
    m |= 1u << id[i];
    row[33 + i] = m;
  }
}

// The stream word of probability p against one table row.
__device__ __forceinline__ uint32_t stream_word(const uint32_t* row, float p) {
  int c = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) c += __uint_as_float(row[c + step - 1]) < p ? step : 0;
  c += __uint_as_float(row[c]) < p ? 1 : 0;  // c in [0, 32]
  return row[32 + c];
}

// Activation streams: xbits[i, w] for the MP probabilities of x, all ports
// sharing the W table rows at tab.
template <typename T>
__global__ void pack_x(const T* __restrict__ x, const uint32_t* __restrict__ tab, int W,
                       uint32_t* __restrict__ xbits, size_t MP) {
  __shared__ uint32_t t[MAX_WORDS * ROW];
  for (int i = threadIdx.x; i < W * ROW; i += blockDim.x) t[i] = tab[i];
  __syncthreads();
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < MP;
       i += (size_t)gridDim.x * blockDim.x) {
    const float p = repro_epi::load<T>(x, i);
    for (int w = 0; w < W; ++w) xbits[i * W + w] = stream_word(t + w * ROW, p);
  }
}

// OR-accumulated AND products, one word of the streams per pass.
//   SRC_PLANES:      acc_p = contraction with [wa; wb]        (K4)
//   SRC_PLANES_DUAL: acc_p with [wa; wb], acc_n with [wb; wa] (K5)
//   SRC_WORDS:       acc_p with pre-packed words wbits [K, N, W]
// For the planes, K is the half-port count (ports 2K); for words, the port
// count.  Blocks along z take k_split half-ports each and OR into the
// accumulators with atomics when there is more than one.
template <int SRC, typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    contract(const uint32_t* __restrict__ xbits, const T* __restrict__ wa,
             const T* __restrict__ wb, const uint32_t* __restrict__ wbits,
             const uint32_t* __restrict__ tab, uint32_t* __restrict__ acc_p,
             uint32_t* __restrict__ acc_n, int M, int N, int K, int W, int k_split,
             int use_atomic) {
  constexpr int TX = BN / TN;
  constexpr int NT = (BM / TM) * TX;
  constexpr bool DUAL = SRC == SRC_PLANES_DUAL;
  constexpr bool HALVES = SRC != SRC_WORDS;
  constexpr int H = HALVES ? 2 : 1;  // ports k and k + K
  __shared__ uint32_t xs[H][BK][BM + 1];
  __shared__ uint32_t tb[H][HALVES ? BK : 1][ROW];
  __shared__ uint32_t ws[H][BK][BN];
  __shared__ uint32_t wn[DUAL ? H : 1][DUAL ? BK : 1][BN];

  const int P = HALVES ? 2 * K : K;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_split;
  const int ke = min(K, kb + k_split);

  for (int w = 0; w < W; ++w) {
    uint32_t ap[TM][TN], an[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) ap[i][j] = an[i][j] = 0u;

    for (int k0 = kb; k0 < ke; k0 += BK) {
      for (int i = tid; i < H * BK * BM; i += NT) {
        const int h = i / (BK * BM), r = i % (BK * BM);
        const int kk = r / BM, mm = r % BM;
        const int gk = k0 + kk, gm = m0 + mm;
        uint32_t v = 0u;
        if (gk < ke && gm < M) v = xbits[((size_t)gm * P + gk + h * K) * W + w];
        xs[h][kk][mm] = v;
      }
      if constexpr (HALVES) {
        for (int i = tid; i < H * BK * ROW; i += NT) {
          const int h = i / (BK * ROW), r = i % (BK * ROW);
          const int kk = r / ROW, j = r % ROW;
          const int gk = k0 + kk;
          tb[h][kk][j] = gk < ke ? tab[((size_t)(gk + h * K) * W + w) * ROW + j] : 0u;
        }
      }
      __syncthreads();
      for (int i = tid; i < BK * BN; i += NT) {
        const int kk = i / BN, nn = i % BN;
        const int gk = k0 + kk, gn = n0 + nn;
        const bool ok = gk < ke && gn < N;
        if constexpr (SRC == SRC_WORDS) {
          ws[0][kk][nn] = ok ? wbits[((size_t)gk * N + gn) * W + w] : 0u;
        } else {
          uint32_t pt = 0u, pb = 0u, nt = 0u, nb = 0u;
          if (ok) {
            const float a = repro_epi::load<T>(wa, (size_t)gk * N + gn);
            const float b = repro_epi::load<T>(wb, (size_t)gk * N + gn);
            pt = stream_word(tb[0][kk], a);  // port k:     top row of [wa; wb]
            pb = stream_word(tb[1][kk], b);  // port k + K: bottom row
            if constexpr (DUAL) {
              nt = stream_word(tb[0][kk], b);  // [wb; wa]
              nb = stream_word(tb[1][kk], a);
            }
          }
          ws[0][kk][nn] = pt;
          ws[H - 1][kk][nn] = pb;
          if constexpr (DUAL) {
            wn[0][kk][nn] = nt;
            wn[1][kk][nn] = nb;
          }
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        uint32_t xt[TM], xb[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          xt[i] = xs[0][kk][ty * TM + i];
          xb[i] = HALVES ? xs[H - 1][kk][ty * TM + i] : 0u;
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = tx + j * TX;
          const uint32_t p0 = ws[0][kk][n];
          const uint32_t p1 = HALVES ? ws[H - 1][kk][n] : 0u;
#pragma unroll
          for (int i = 0; i < TM; ++i) ap[i][j] |= (xt[i] & p0) | (xb[i] & p1);
          if constexpr (DUAL) {
            const uint32_t q0 = wn[0][kk][n], q1 = wn[1][kk][n];
#pragma unroll
            for (int i = 0; i < TM; ++i) an[i][j] |= (xt[i] & q0) | (xb[i] & q1);
          }
        }
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
        const size_t o = ((size_t)gm * N + gn) * W + w;
        if (use_atomic) {
          atomicOr(acc_p + o, ap[i][j]);
          if constexpr (DUAL) atomicOr(acc_n + o, an[i][j]);
        } else {
          acc_p[o] = ap[i][j];
          if constexpr (DUAL) acc_n[o] = an[i][j];
        }
      }
    }
  }
}

template <int SRC, typename T, int BM, int BN, int BK, int TM, int TN>
void run_contract(const uint32_t* xbits, const void* wa, const void* wb, const uint32_t* wbits,
                  const uint32_t* tab, uint32_t* acc_p, uint32_t* acc_n, int M, int N, int K,
                  int W, cudaStream_t st) {
  const int gx = (N + BN - 1) / BN, gy = (M + BM - 1) / BM;
  const int kblocks = (K + BK - 1) / BK;
  // split K until about two blocks per SM are in flight
  const int want = (2 * repro_epi::sm_count() + gx * gy - 1) / (gx * gy);
  const int parts = std::min(kblocks, std::max(1, want));
  const int k_split = ((kblocks + parts - 1) / parts) * BK;
  const int splits = (K + k_split - 1) / k_split;
  const size_t words = (size_t)M * N * W * sizeof(uint32_t);
  if (splits > 1) {
    cudaMemsetAsync(acc_p, 0, words, st);
    if (SRC == SRC_PLANES_DUAL) cudaMemsetAsync(acc_n, 0, words, st);
  }
  contract<SRC, T, BM, BN, BK, TM, TN><<<dim3(gx, gy, splits), (BM / TM) * (BN / TN), 0, st>>>(
      xbits, static_cast<const T*>(wa), static_cast<const T*>(wb), wbits, tab, acc_p, acc_n, M,
      N, K, W, k_split, splits > 1);
}

template <int SRC, typename T>
void contract_any(const uint32_t* xbits, const void* wa, const void* wb, const uint32_t* wbits,
                  const uint32_t* tab, uint32_t* acc_p, uint32_t* acc_n, int M, int N, int K,
                  int W, cudaStream_t st) {
  // both polarities' words take twice the shared memory: half the depth
  constexpr int BK = SRC == SRC_PLANES_DUAL ? 8 : 16;
  if (M <= 4)
    run_contract<SRC, T, 4, 128, 16, 4, 1>(xbits, wa, wb, wbits, tab, acc_p, acc_n, M, N, K, W,
                                           st);
  else
    run_contract<SRC, T, 64, 128, BK, 8, 4>(xbits, wa, wb, wbits, tab, acc_p, acc_n, M, N, K, W,
                                            st);
}

// Tables for the weight ports (rows 0 .. 2K*W-1) and the shared activation
// sequence (rows 2K*W ..), then the activation streams.
template <typename T>
void prepare(const void* x, const float* ux, const float* uw, uint32_t* tab, uint32_t* xbits,
             int M, int K, int W, cudaStream_t st) {
  const int P = 2 * K;
  const int rows = P * W;
  build_tables<<<(rows + 127) / 128, 128, 0, st>>>(uw, rows, tab);
  build_tables<<<1, 32, 0, st>>>(ux, W, tab + (size_t)rows * ROW);
  pack_x<T><<<repro_epi::grid_for((size_t)M * P, 256), 256, 0, st>>>(
      static_cast<const T*>(x), tab + (size_t)rows * ROW, W, xbits, (size_t)M * P);
}

__global__ void counts_to_value(const uint32_t* __restrict__ acc, int W, float bits,
                                float* __restrict__ out, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    int c = 0;
    for (int w = 0; w < W; ++w) c += __popc(acc[i * W + w]);
    out[i] = __fdiv_rn(__int2float_rn(c), bits);
  }
}

// K5's value before the epilogue: (count_p / bits - count_n / bits) times
// the row's prescale, rounded to the output type.
template <typename T>
struct PlaneDifference {
  const uint32_t* acc_p;
  const uint32_t* acc_n;
  int W;
  float bits;
  const float* pre;
  __device__ float operator()(size_t i, int m) const {
    int cp = 0, cn = 0;
    for (int w = 0; w < W; ++w) {
      cp += __popc(acc_p[i * W + w]);
      cn += __popc(acc_n[i * W + w]);
    }
    const float r = __fsub_rn(__fdiv_rn(__int2float_rn(cp), bits),
                              __fdiv_rn(__int2float_rn(cn), bits));
    return repro_epi::rnd<T>(__fmul_rn(r, pre[m]));
  }
};

template <typename T>
void fused(const void* x, const void* wp, const void* wn, const float* ux, const float* uw,
           uint32_t* tab, uint32_t* xbits, uint32_t* acc_p, uint32_t* acc_n, int M, int N, int K,
           int W, cudaStream_t st) {
  prepare<T>(x, ux, uw, tab, xbits, M, K, W, st);
  contract_any<SRC_PLANES_DUAL, T>(xbits, wp, wn, nullptr, tab, acc_p, acc_n, M, N, K, W, st);
}

}  // namespace
}  // namespace repro_sc

using namespace repro_sc;

// K4: out[M,N] (float32) = popcount(OR_k(xs[m,k] & ws[k,n])) / bits over the
// 2K ports, where xs are the streams of x [M, 2K] against ux [bits] and ws
// those of the plane [wa; wb] ([K, N] each) against uw [2K, bits].  x, wa,
// wb: float32 or bfloat16 probabilities.  Scratch: tab ((2K+1)*W*65 words),
// xbits (M*2K*W), acc (M*N*W), W = bits / 32.
extern "C" int sc_matmul(int in_bf16, const void* x, const void* wa, const void* wb,
                         const float* ux, const float* uw, uint32_t* tab, uint32_t* xbits,
                         uint32_t* acc, float* out, int M, int N, int K, int bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = bits / 32;
  if (in_bf16) {
    prepare<__nv_bfloat16>(x, ux, uw, tab, xbits, M, K, W, st);
    contract_any<SRC_PLANES, __nv_bfloat16>(xbits, wa, wb, nullptr, tab, acc, nullptr, M, N, K,
                                            W, st);
  } else {
    prepare<float>(x, ux, uw, tab, xbits, M, K, W, st);
    contract_any<SRC_PLANES, float>(xbits, wa, wb, nullptr, tab, acc, nullptr, M, N, K, W, st);
  }
  counts_to_value<<<repro_epi::grid_for((size_t)M * N, 256), 256, 0, st>>>(acc, W, (float)bits,
                                                                          out, (size_t)M * N);
  return (int)cudaGetLastError();
}

// K4 on pre-packed words, the reference kernel's own interface:
// out[M,N] = popcount(OR_k(xbits[m,k,:] & wbits[k,n,:])) / bits over P ports.
extern "C" int sc_matmul_words(const uint32_t* xbits, const uint32_t* wbits, uint32_t* acc,
                               float* out, int M, int N, int P, int bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = bits / 32;
  contract_any<SRC_WORDS, float>(xbits, nullptr, nullptr, wbits, nullptr, acc, nullptr, M, N, P,
                                 W, st);
  counts_to_value<<<repro_epi::grid_for((size_t)M * N, 256), 256, 0, st>>>(acc, W, (float)bits,
                                                                          out, (size_t)M * N);
  return (int)cudaGetLastError();
}

// K5: both polarities, w_pos = [wp; wn] and w_neg = [wn; wp], against the
// same streams; then ((count_p / bits - count_n / bits) * pre[m]) cast to the
// output type, then the epilogue as in K2 (chip term when add != NULL, then
// the correction polynomial when P > 0).  Scratch as K4, with acc_n beside
// acc_p.
extern "C" int sc_matmul_fused(int in_bf16, int out_bf16, const void* x, const void* wp,
                               const void* wn, const float* ux, const float* uw, uint32_t* tab,
                               uint32_t* xbits, uint32_t* acc_p, uint32_t* acc_n,
                               const float* pre, const void* gain, const void* add,
                               const float* coeffs, int P, float mean_scale, float eps, void* out,
                               int M, int N, int K, int bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = bits / 32;
  if (in_bf16)
    fused<__nv_bfloat16>(x, wp, wn, ux, uw, tab, xbits, acc_p, acc_n, M, N, K, W, st);
  else
    fused<float>(x, wp, wn, ux, uw, tab, xbits, acc_p, acc_n, M, N, K, W, st);
  if (out_bf16)
    repro_epi::finish<__nv_bfloat16>(
        PlaneDifference<__nv_bfloat16>{acc_p, acc_n, W, (float)bits, pre}, gain, add, coeffs, P,
        mean_scale, eps, out, M, N, st);
  else
    repro_epi::finish<float>(PlaneDifference<float>{acc_p, acc_n, W, (float)bits, pre}, gain,
                             add, coeffs, P, mean_scale, eps, out, M, N, st);
  return (int)cudaGetLastError();
}

extern "C" const char* sc_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
