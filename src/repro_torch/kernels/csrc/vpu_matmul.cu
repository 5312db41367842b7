// Multiplier-error contractions on Hopper CUDA cores: kernels K1 and K2.
//
// Replaces the Pallas TPU kernels repro/kernels/vpu_matmul.py:
//   elementwise_matmul        (_kernel)        -> vpu_matmul()
//   elementwise_matmul_fused  (_fused_kernel)  -> vpu_quantize_matmul_fused(),
//                                                 vpu_matmul_fused()
// instantiated for the truncated multiplier (approx_mult.py) and the
// Mitchell logarithmic multiplier (log_matmul.py).  K2's serving entry,
// vpu_quantize_matmul_fused(), also takes in the operand quantisation that
// XLA fuses in front of the pallas_call on the TPU
// (repro/core/backends.py:_int_operand_quantize):
//   sx  = max(amax(|x|, row), eps)   sw = max(amax(|w|), eps)
//   xi  = round(clamp(x / sx, -1, 1) * levels), wi likewise with sw
//   pre = (sx * sw) / rnd(levels^2)
//   out = epilogue(rnd_out(float(sum_k mul(xi, wi)) * pre))
// every op rounded to the operand type as the plain version rounds it.
// vpu_matmul_fused() is the same contraction on integer-valued operands
// with a given prescale: the Pallas kernel's own interface.
//
// What bounds them on this card: operations.  Every product passes through
// a nonlinear scalar multiplier, so tensor cores cannot be used; each
// product is 3 (truncated) or 7 (Mitchell) integer instructions on the
// CUDA cores.  At decode (M = 4) quantising a weight costs as much again
// when computed (a correctly rounded division and four roundings, ~20
// instructions, shared over the 4 rows).  Below both: the bf16 weight's
// two reads (45 MB at 2048 x 11008: 13.5 us each at 3.35 TB/s).
//
// What the design does about it:
// * Operands are integers of at most 8 bits, so each product is computed
//   in int32 arithmetic and summed in an int32 accumulator: exact, hence
//   independent of order, tile shape and split-K.  floor(log2) comes from
//   __clz, never from an approximate lg2.
// * K2 is three launches and no memset.  The scale pass reads x and w
//   once: integer atomicMax of |v|'s bit patterns (the max of non-negative
//   floats is order-free); its last block turns the maxima into sx, sw and
//   pre, builds the level table (below), and zeroes what it used.  The
//   contraction streams each weight once, by 16-byte cp.async copies into
//   a ring of 4 stages of 8 rows; a block takes a 256-column tile, a lane
//   8 adjacent columns, and each of the 4 warps 2 rows of every stage.  The
//   stage's 32 activations are quantised by the 32 lanes and passed by
//   shuffles.  K is split across blocks (at most 32 a tile) to fill whole
//   waves of the card; the warps add their sums in shared memory and the
//   block adds them into int32 accumulators with atomics.  The finishing
//   pass (repro_epi::finish) zeroes each accumulator after its last read,
//   so the accumulators stay clear between calls.  M > 4 runs the
//   contraction once per 4 rows (grid y).
// * The level table.  Once sw is known, the level of a bf16 weight is a
//   function of its 16 bits: the scale pass quantises each bit pattern of
//   the 11 binades up to sw's (1408 patterns, __fdiv_rn and round-to-
//   nearest-even conversions, as the plain version rounds), and smaller
//   patterns quantise to 0.  The contraction finds a weight's level by
//   one shared-memory load, not by ~20 instructions; float32 operands are
//   quantised one by one.
// * Per product, from a weight's level |b|, sign and 2^floor(log2 |b|):
//   truncated, sign(b) * ((a |b| + (low & sign a)) & ~low), the product
//   rounded toward zero; Mitchell, S - T plus (S - 3T when it has T's
//   sign) with S - T = a pb + pa (b - pb) and S - 3T = a pb + pa (b - 3 pb).
//   Written as sign(ab) * (|ab| & ~low) with |ab| = (ab ^ s) - s, as K1's
//   product<> reads, the truncated product compiles to IABS and ran 2.4x
//   slower than this form in K1's contraction (PERF.md).
// * K1 (prefill) keeps its shared-memory tiles: each thread owns a TM x TN
//   register tile, x and w tiles are staged in shared memory, and K is
//   split across blocks (a memset and atomics) when the output tiles alone
//   cannot fill the SMs; a last pass converts the sums to float.
// * Ragged M, N and K are masked in the kernels (zero operands give zero
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

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

constexpr unsigned FULL = 0xffffffffu;

namespace k2 {
constexpr int BM = 4;           // activation rows of a block (the decode slots)
constexpr int CPL = 8;          // columns of a lane
constexpr int TW = 32 * CPL;    // columns of a block: one 256-column tile
constexpr int WARPS = 4;        // warps of a block, each taking rows of every stage
constexpr int R = 8;            // weight rows of a stage
constexpr int RPW = R / WARPS;  // rows of a stage a warp takes: warp, warp + WARPS
static_assert(BM * R == 32, "one lane quantises each activation of a stage");
constexpr int STAGES = 4;       // depth of the block's ring
constexpr int NT = WARPS * 32;  // threads of a block
// blocks an SM holds: 20 KB of shared memory a block in bf16, 36 KB in
// float32, at most 128 registers a thread
constexpr int BLOCKS_PER_SM = 4;
constexpr int MAX_SPLITS = 32;  // blocks adding into one accumulator at most
constexpr int SCALE_NT = 256;   // threads of a scale-pass block
// The level table of bf16 weights: for the 11 binades of |w| patterns up
// to sw's (1408 patterns: 10 binades below sw's exponent and its own), the
// quantised level of each, with 2^floor(log2 level) in the high byte.
// Smaller patterns quantise to 0, as the table's first entry does.
constexpr int TAB = 11 * 128;
// The scales buffer, in 4-byte words: the table, its first pattern, sw,
// then sx[M] and pre[M].
constexpr int SC_BASE = TAB / 2;
constexpr int SC_SW = SC_BASE + 1;
constexpr int SC_SX = SC_SW + 1;
}  // namespace k2

// One stage of the ring: rows s0 .. s0 + R - 1 of w for the block's
// columns, and x at those rows for the block's 4 slots.
template <typename T>
struct alignas(16) Stage {
  T w[k2::R][k2::TW];
  T x[k2::BM][k2::R];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // bytes past src_bytes are zero-filled; with 0, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// round(clamp(v / s, -1, 1) * lev) as an integer, each op rounded to T as
// the plain version rounds it: the quotient correctly rounded in float32
// (__fdiv_rn, as PyTorch divides) and then to T, the product with lev
// (exact in float32 for bf16) rounded to T, then half to even.  The last
// rounding adds 1.5 * 2^23, which rounds to nearest even in float32 for
// |v| <= 255, and reads the integer from the sum's low bits.
template <typename T>
__device__ __forceinline__ int quantize(float v, float s, float lev) {
  float q = repro_epi::rnd<T>(__fdiv_rn(v, s));
  q = fminf(fmaxf(q, -1.0f), 1.0f);
  q = repro_epi::rnd<T>(__fmul_rn(q, lev));
  return __float_as_int(__fadd_rn(q, 12582912.0f)) - 0x4B400000;
}

// The operand as an integer: quantised from the value, or (the integer
// entry) the integer-valued operand rounded to the nearest integer.
template <bool QUANT, typename T>
__device__ __forceinline__ int operand(float v, float s, float lev) {
  if constexpr (QUANT)
    return quantize<T>(v, s, lev);
  else
    return __float2int_rn(v);
}

// 2^floor(log2 m) for m > 0; 0 for m == 0.
__device__ __forceinline__ int pow2_below(int m) { return m ? 1 << (31 - __clz(m)) : 0; }

// A weight as the products take it: its magnitude, its sign (0 or -1) and
// 2^floor(log2 magnitude).
struct WeightOp {
  int mag, sgn, pw;
};

// The lane's CPL weights of a stage row.  With TABLE (bf16 operands,
// quantised), each from the level table by its bit pattern: the level of
// |w| is the entry of pattern |w| - base (patterns below base quantise to
// 0, as entry 0 does); else from the value.
template <bool QUANT, bool TABLE, typename T>
__device__ __forceinline__ void weight_ops(const T* row, const unsigned short* tab, int base,
                                           float sw, float lev, WeightOp (&op)[k2::CPL]) {
  using namespace k2;
  if constexpr (TABLE) {
    const uint4 q = *reinterpret_cast<const uint4*>(row);
    const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const unsigned bits = c & 1 ? u[c / 2] >> 16 : u[c / 2] & 0xffffu;
      const unsigned e = tab[max((int)(bits & 0x7fffu) - base, 0)];
      op[c] = {(int)(e & 0xffu), -(int)(bits >> 15), (int)(e >> 8)};
    }
  } else {
    float v[CPL];
    if constexpr (sizeof(T) == 2) {
      const uint4 q = *reinterpret_cast<const uint4*>(row);
      const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        v[2 * h] = __uint_as_float(u[h] << 16);
        v[2 * h + 1] = __uint_as_float(u[h] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int h = 0; h < CPL / 4; ++h) {
        const float4 q = reinterpret_cast<const float4*>(row)[h];
        v[4 * h + 0] = q.x, v[4 * h + 1] = q.y, v[4 * h + 2] = q.z, v[4 * h + 3] = q.w;
      }
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int b = operand<QUANT, T>(v[c], sw, lev);
      const int m = abs(b);
      op[c] = {m, b >> 31, pow2_below(m)};
    }
  }
}

// Rows [s0, s0 + R) of the block's range [.., r1) into a stage, every
// thread of the block taking its share: with VEC, cp.async copies
// (zero-filled past the range, past M and past N); without (N or K not a
// multiple of the copy, or a pointer not aligned for it), element loads.
template <typename T, bool VEC>
__device__ __forceinline__ void load_stage(Stage<T>& sg, const T* __restrict__ x,
                                           const T* __restrict__ w, int s0, int r1, int m0,
                                           int nb, int M, int N, int K, int tid) {
  using namespace k2;
  const int rows = min(R, r1 - s0);
  if constexpr (VEC) {
    constexpr int CE = 16 / sizeof(T);  // elements per copy
    for (int i = tid; i < R * TW / CE; i += NT) {
      const int rr = i / (TW / CE), j = i % (TW / CE);
      const int n = nb + j * CE;
      const bool ok = rr < rows && n < N;
      cp_async16(&sg.w[rr][j * CE], w + (ok ? (size_t)(s0 + rr) * N + n : 0), ok ? 16 : 0);
    }
    if (tid < BM * R / CE) {  // R elements of x at each slot; K % R == 0
      const int m = tid / (R / CE), j = tid % (R / CE);
      const bool ok = m0 + m < M;
      cp_async16(&sg.x[m][j * CE], x + (ok ? (size_t)(m0 + m) * K + s0 + j * CE : 0),
                 ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < R * TW; i += NT) {
      const int rr = i / TW, n = nb + i % TW;
      sg.w[rr][i % TW] = rr < rows && n < N ? w[(size_t)(s0 + rr) * N + n] : T(0.0f);
    }
    for (int i = tid; i < BM * R; i += NT) {
      const int m = i / R, rr = i % R;
      sg.x[m][rr] = rr < rows && m0 + m < M ? x[(size_t)(m0 + m) * K + s0 + rr] : T(0.0f);
    }
  }
}

// Block (x, y, z): columns [256 x, 256 x + 256), activation rows [4 y,
// 4 y + 4), rows [r0, r1) of split z, spb stages of R rows each.  Warp v
// takes rows v and v + 4 of every stage, a lane 8 adjacent columns of the
// tile.  QUANT: the operands are quantised with the scale pass's sx and sw
// (scales, laid out as k2::SC_*); TABLE: the bf16 weights through its
// level table.  Else they are integer-valued.  The warps' sums are added
// together in shared memory, then into acc [M, N] with atomics.
template <int MUL, bool QUANT, bool TABLE, typename T, bool VEC>
__global__ void __launch_bounds__(k2::NT, k2::BLOCKS_PER_SM)
    decode_contract(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ scales, int* __restrict__ acc, int M, int N, int K,
                    int spb, int drop_bits, float lev) {
  using namespace k2;
  static_assert(!TABLE || (QUANT && sizeof(T) == 2), "the level table is of bf16 weights");
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<T>* ring = reinterpret_cast<Stage<T>*>(smem);
  constexpr int RING = (STAGES * sizeof(Stage<T>) > WARPS * BM * TW * sizeof(int))
                           ? STAGES * sizeof(Stage<T>)
                           : WARPS * BM * TW * sizeof(int);
  unsigned short* tab = reinterpret_cast<unsigned short*>(smem + RING);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.z * spb * R, r1 = min(K, r0 + spb * R);
  const int m0 = blockIdx.y * BM, nb = blockIdx.x * TW;
  const int n_st = (r1 - r0 + R - 1) / R;
  const int low = (1 << drop_bits) - 1;  // the truncated product's dropped bits

  if constexpr (TABLE) {  // the level table, in the first copy group
    for (int i = tid; i < TAB * 2 / 16; i += NT) cp_async16(tab + 8 * i, scales + 4 * i, 16);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_st) load_stage<T, VEC>(ring[s], x, w, r0 + s * R, r1, m0, nb, M, N, K, tid);
    cp_async_commit();
  }
  // the scales: sw for the weights, and sx of slot lane % 4 for the
  // activation this lane quantises
  float sw = 1.0f, sx = 1.0f;
  int base = 0;
  if constexpr (QUANT) {
    sw = scales[SC_SW];
    base = __float_as_int(scales[SC_BASE]);
    if (m0 + (lane & 3) < M) sx = scales[SC_SX + m0 + (lane & 3)];
  }

  int a[BM][CPL];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < CPL; ++c) a[m][c] = 0;

  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage st has landed; every warp is done with stage st - 1
    const int nx = st + STAGES - 1;
    if (nx < n_st)
      load_stage<T, VEC>(ring[nx % STAGES], x, w, r0 + nx * R, r1, m0, nb, M, N, K, tid);
    cp_async_commit();

    const Stage<T>& sg = ring[st % STAGES];
    // the stage's activations, one a lane: slot lane % 4, row lane / 4
    // (zero past the range and past M, as are the weights there), with the
    // companion its products need: truncated, low & sign; Mitchell,
    // sign * 2^floor(log2 |a|)
    const int xo = operand<QUANT, T>(to_f32(sg.x[lane & 3][lane >> 2]), sx, lev);
    const int xc = MUL == MUL_APPROX ? low & (xo >> 31) : signed_pow2(xo);
    int xa[RPW][BM], xb[RPW][BM];
    WeightOp op[RPW][CPL];
#pragma unroll
    for (int h = 0; h < RPW; ++h) {
      const int rr = warp + h * WARPS;
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        xa[h][m] = __shfl_sync(FULL, xo, rr * BM + m);
        xb[h][m] = __shfl_sync(FULL, xc, rr * BM + m);
      }
      weight_ops<QUANT, TABLE, T>(&sg.w[rr][lane * CPL], tab, base, sw, lev, op[h]);
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if constexpr (MUL == MUL_APPROX) {
        // sign(b) * trunc(a |b|): a |b| has a's sign, so it rounds toward
        // zero by adding low & sign(a) before the low bits are cleared
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          int sum = 0;
#pragma unroll
          for (int h = 0; h < RPW; ++h) {
            const WeightOp& b = op[h][c];
            sum += (((xa[h][m] * b.mag + xb[h][m]) & ~low) ^ b.sgn) - b.sgn;
          }
          a[m][c] += sum;
        }
      } else {
        // Mitchell as in product<MUL_MITCHELL>, with S = a pb + b pa and
        // T = pa pb: S - T + (S - 3T when it has T's sign, or is 0)
        int pb[RPW], b1[RPW], b3[RPW];
#pragma unroll
        for (int h = 0; h < RPW; ++h) {
          const WeightOp& b = op[h][c];
          const int bs = (b.mag ^ b.sgn) - b.sgn;
          pb[h] = (b.pw ^ b.sgn) - b.sgn;
          b1[h] = bs - pb[h];
          b3[h] = bs - 3 * pb[h];
        }
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          int sum = 0;
#pragma unroll
          for (int h = 0; h < RPW; ++h) {
            const int ab = xa[h][m] * pb[h];
            const int u = xb[h][m] * b1[h] + ab;  // S - T
            const int d = xb[h][m] * b3[h] + ab;  // S - 3T
            sum += u + ((d ^ xb[h][m] ^ pb[h]) >= 0 ? d : 0);
          }
          a[m][c] += sum;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // add the warps' sums in shared memory, [warp][slot][column], then into acc
  int* part = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int h = 0; h < CPL / 4; ++h)
      reinterpret_cast<int4*>(part + (warp * BM + m) * TW + lane * CPL)[h] =
          make_int4(a[m][4 * h], a[m][4 * h + 1], a[m][4 * h + 2], a[m][4 * h + 3]);
  __syncthreads();
  for (int i = tid; i < BM * TW; i += NT) {
    int sum = 0;
#pragma unroll
    for (int v = 0; v < WARPS; ++v) sum += part[v * BM * TW + i];
    const int gm = m0 + i / TW, n = nb + i % TW;
    if (sum != 0 && gm < M && n < N) atomicAdd(acc + (size_t)gm * N + n, sum);
  }
}

// Grid and stages per split for a shape: the split of K that keeps the most
// block slots of the card busy over whole waves, the fewer splits on a tie,
// each split at least 2 stages (16 rows) long and at most MAX_SPLITS
// splits (each adds into the same accumulators).
struct DecodePlan {
  int gx, gy, gz, spb;
};

DecodePlan decode_plan(int M, int N, int K) {
  using namespace k2;
  DecodePlan p;
  p.gx = (N + TW - 1) / TW;
  p.gy = (M + BM - 1) / BM;
  const int U = (K + R - 1) / R;
  const long long base = (long long)p.gx * p.gy;
  const long long slots = (long long)repro_epi::sm_count() * BLOCKS_PER_SM;
  const int max_splits =
      std::max(1, std::min({(U + 1) / 2, MAX_SPLITS, (int)(4 * slots / base) + 1}));
  double best = -1.0;
  for (int splits = 1; splits <= max_splits; ++splits) {
    const int spb = (U + splits - 1) / splits;
    const int gz = (U + spb - 1) / spb;
    const long long waves = (base * gz + slots - 1) / slots;
    const double use = (double)base * U / ((double)waves * slots * spb);
    if (use > best + 1e-9) {
      best = use;
      p.spb = spb;
      p.gz = gz;
    }
  }
  return p;
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <int MUL, bool QUANT, bool TABLE, typename T, bool VEC>
void launch_decode(const T* x, const T* w, const float* scales, int* acc, int M, int N, int K,
                   int drop_bits, float lev, cudaStream_t st) {
  using namespace k2;
  const DecodePlan p = decode_plan(M, N, K);
  const int ring = std::max(STAGES * (int)sizeof(Stage<T>), WARPS * BM * TW * (int)sizeof(int));
  const int smem = ring + (TABLE ? TAB * 2 : 0);
  static bool attr = [smem] {
    cudaFuncSetAttribute(decode_contract<MUL, QUANT, TABLE, T, VEC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(decode_contract<MUL, QUANT, TABLE, T, VEC>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    return true;
  }();
  (void)attr;
  decode_contract<MUL, QUANT, TABLE, T, VEC><<<dim3(p.gx, p.gy, p.gz), NT, smem, st>>>(
      x, w, scales, acc, M, N, K, p.spb, drop_bits, lev);
}

template <int MUL, bool QUANT, typename T>
void run_decode(const void* x, const void* w, const float* scales, int* acc, int M, int N,
                int K, int drop_bits, float lev, cudaStream_t st) {
  // 16-byte copies of w rows and of x's R elements at a slot
  const bool vec = N % (16 / sizeof(T)) == 0 && K % k2::R == 0 && aligned(w, 16) &&
                   aligned(x, 16);
  constexpr bool TABLE = QUANT && sizeof(T) == 2;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  if (vec)
    launch_decode<MUL, QUANT, TABLE, T, true>(xt, wt, scales, acc, M, N, K, drop_bits, lev, st);
  else
    launch_decode<MUL, QUANT, TABLE, T, false>(xt, wt, scales, acc, M, N, K, drop_bits, lev,
                                               st);
}

template <bool QUANT>
void decode_dispatch(int mul, int in_bf16, const void* x, const void* w, const float* scales,
                     int* acc, int M, int N, int K, int drop_bits, float lev, cudaStream_t st) {
  if (mul == MUL_APPROX) {
    if (in_bf16)
      run_decode<MUL_APPROX, QUANT, __nv_bfloat16>(x, w, scales, acc, M, N, K, drop_bits, lev,
                                                   st);
    else
      run_decode<MUL_APPROX, QUANT, float>(x, w, scales, acc, M, N, K, drop_bits, lev, st);
  } else {
    if (in_bf16)
      run_decode<MUL_MITCHELL, QUANT, __nv_bfloat16>(x, w, scales, acc, M, N, K, drop_bits,
                                                     lev, st);
    else
      run_decode<MUL_MITCHELL, QUANT, float>(x, w, scales, acc, M, N, K, drop_bits, lev, st);
  }
}

// |v| as the bit pattern of a float: its order is that of |v| (NaN above
// every number, as a max with NaN is NaN).
__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(v) & 0x7fffffffu; }
__device__ __forceinline__ unsigned abs_bits(__nv_bfloat16 v) {
  return (unsigned)(__bfloat16_as_ushort(v) & 0x7fffu) << 16;
}

// The max of 16 bytes of w, as abs_bits.
__device__ __forceinline__ unsigned abs_max16(uint4 q, __nv_bfloat16) {
  // two bf16 a word: a 16-bit max of each half, then of the two halves
  const unsigned h = __vmaxu2(__vmaxu2(q.x & 0x7fff7fffu, q.y & 0x7fff7fffu),
                              __vmaxu2(q.z & 0x7fff7fffu, q.w & 0x7fff7fffu));
  return max(h << 16, h & 0xffff0000u);
}
__device__ __forceinline__ unsigned abs_max16(uint4 q, float) {
  return max(max(q.x & 0x7fffffffu, q.y & 0x7fffffffu), max(q.z & 0x7fffffffu, q.w & 0x7fffffffu));
}

// The scale pass.  Blocks [0, wblocks) take grid-stride shares of w (with
// VEC, 16 bytes a load, four loads in flight a thread); block wblocks + m
// takes row m of x.  Each block adds its max into hold (atomicMax of
// abs_bits: hold[1] for w, hold[2 + m] for row m), then counts itself in
// hold[0]; the last block to count reads the maxima and writes, as laid
// out by k2::SC_*, sw, sx[M] and pre = rnd((sx * sw) / lev2) (each max
// floored at eps, every op rounded to T) and, for bf16, the level table of
// the weights; and zeroes hold.
template <typename T, bool VEC>
__global__ void __launch_bounds__(k2::SCALE_NT)
    scale_pass(const T* __restrict__ x, const T* __restrict__ w, unsigned* __restrict__ hold,
               float* __restrict__ scales, int M, int K, size_t KN, int wblocks, float eps,
               float lev, float lev2) {
  using namespace k2;
  __shared__ unsigned red[SCALE_NT / 32];
  __shared__ bool last;
  const int tid = threadIdx.x;
  unsigned mx = 0u;
  if ((int)blockIdx.x < wblocks) {
    const size_t stride = (size_t)wblocks * SCALE_NT;
    size_t i = (size_t)blockIdx.x * SCALE_NT + tid;
    if constexpr (VEC) {
      const uint4* wv = reinterpret_cast<const uint4*>(w);
      const size_t nv = KN * sizeof(T) / 16;
      for (; i + 3 * stride < nv; i += 4 * stride) {
        uint4 q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) q[j] = wv[i + j * stride];
#pragma unroll
        for (int j = 0; j < 4; ++j) mx = max(mx, abs_max16(q[j], T()));
      }
      for (; i < nv; i += stride) mx = max(mx, abs_max16(wv[i], T()));
    } else {
      for (; i < KN; i += stride) mx = max(mx, abs_bits(w[i]));
    }
  } else {
    const T* row = x + (size_t)(blockIdx.x - wblocks) * K;
    for (int k = tid; k < K; k += SCALE_NT) mx = max(mx, abs_bits(row[k]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(FULL, mx, o));
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int j = 1; j < SCALE_NT / 32; ++j) mx = max(mx, red[j]);
    const int b = blockIdx.x;
    atomicMax(b < wblocks ? hold + 1 : hold + 2 + (b - wblocks), mx);
    __threadfence();  // the max lands before the count
    last = atomicAdd(hold, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // every other block has added its max: read them, and leave hold zero
  const unsigned eps_bits = __float_as_uint(eps);
  __shared__ float s_sw;
  if (tid == 0) s_sw = __uint_as_float(max(atomicExch(hold + 1, 0u), eps_bits));
  __syncthreads();
  const float sw = s_sw;
  for (int m = tid; m < M; m += SCALE_NT) {
    const float sx = __uint_as_float(max(atomicExch(hold + 2 + m, 0u), eps_bits));
    scales[SC_SX + m] = sx;
    scales[SC_SX + M + m] =
        repro_epi::rnd<T>(__fdiv_rn(repro_epi::rnd<T>(__fmul_rn(sx, sw)), lev2));
  }
  if constexpr (sizeof(T) == 2) {
    // the level table: patterns from 10 binades below sw's exponent
    const int base = max((int)(__float_as_uint(sw) >> 23) - 10, 0) << 7;
    unsigned short* tab = reinterpret_cast<unsigned short*>(scales);
    for (int j = tid; j < TAB; j += SCALE_NT) {
      const int lvl = quantize<T>(__uint_as_float((unsigned)(base + j) << 16), sw, lev);
      tab[j] = (unsigned short)(lvl | pow2_below(lvl) << 8);
    }
    if (tid == 0) scales[SC_BASE] = __int_as_float(base);
  }
  if (tid == 0) {
    scales[SC_SW] = sw;
    atomicExch(hold, 0u);
  }
}

template <typename T>
void run_scales(const void* x, const void* w, unsigned* hold, float* scales, int M, int K,
                int N, float eps, float lev, float lev2, cudaStream_t st) {
  const size_t KN = (size_t)K * N;
  const bool vec = KN * sizeof(T) % 16 == 0 && aligned(w, 16);
  const size_t per_block = (size_t)k2::SCALE_NT * (vec ? 4 * 16 / sizeof(T) : 4);
  const int wblocks =
      (int)std::max<size_t>(1, std::min<size_t>((KN + per_block - 1) / per_block,
                                                (size_t)repro_epi::sm_count() * 8));
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  if (vec)
    scale_pass<T, true><<<wblocks + M, k2::SCALE_NT, 0, st>>>(xt, wt, hold, scales, M, K, KN,
                                                              wblocks, eps, lev, lev2);
  else
    scale_pass<T, false><<<wblocks + M, k2::SCALE_NT, 0, st>>>(xt, wt, hold, scales, M, K, KN,
                                                               wblocks, eps, lev, lev2);
}

// K2's value before the epilogue: the int32 sum times the row's prescale,
// rounded to the output type.  The finishing pass releases each sum after
// its last read: its accumulator is zeroed, ready for the next call.
template <typename T>
struct ScaledSum {
  int* acc;
  const float* pre;
  __device__ float operator()(size_t i, int m) const {
    return repro_epi::rnd<T>(__fmul_rn(__int2float_rn(acc[i]), pre[m]));
  }
  __device__ void release(size_t i) const { acc[i] = 0; }
};

void finish_dispatch(int out_bf16, int* acc, const float* pre, const void* gain, const void* add,
                     const float* coeffs, int P, float mean_scale, float eps, void* out, int M,
                     int N, cudaStream_t st) {
  if (out_bf16)
    repro_epi::finish<__nv_bfloat16>(ScaledSum<__nv_bfloat16>{acc, pre}, gain, add, coeffs, P,
                                     mean_scale, eps, out, M, N, st);
  else
    repro_epi::finish<float>(ScaledSum<float>{acc, pre}, gain, add, coeffs, P, mean_scale, eps,
                             out, M, N, st);
}

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

// K2 on integer-valued operands (the Pallas kernel's interface): the
// contraction, then (acc * pre[m]) cast to the output type, then the
// epilogue: chip term when add != NULL (gain may be NULL: fault family),
// then the correction polynomial when P > 0.  gain/add are in the output
// type.  acc: int32 [M,N], all zero on entry, and left all zero.  Two
// launches.
extern "C" int vpu_matmul_fused(int mul, int in_bf16, int out_bf16, const void* x, const void* w,
                                const float* pre, const void* gain, const void* add,
                                const float* coeffs, int P, float mean_scale, float eps, int* acc,
                                void* out, int M, int N, int K, int drop_bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  decode_dispatch<false>(mul, in_bf16, x, w, nullptr, acc, M, N, K, drop_bits, 0.0f, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;  // not launched: the accumulators are untouched
  finish_dispatch(out_bf16, acc, pre, gain, add, coeffs, P, mean_scale, eps, out, M, N, st);
  return (int)cudaGetLastError();
}

// K2 on the operands themselves, x [M,K] and w [K,N] in float32 or
// bfloat16: the scale pass, the contraction of the operands quantised to
// +-lev (lev = 2^bits - 1, lev2 = lev^2 rounded to the operand type, eps
// = 1e-6 in it), then the prescale, the cast and the epilogue as in
// vpu_matmul_fused.  hold: 2 + M words and acc: int32 [M,N], all zero on
// entry and left all zero; scales: vpu_scales_words(M) words, written (the
// bf16 weights' level table, sw, sx[M], pre[M]).  Three launches.
extern "C" int vpu_quantize_matmul_fused(int mul, int in_bf16, int out_bf16, const void* x,
                                         const void* w, unsigned* hold, float* scales, float lev,
                                         float lev2, float eps_in, const void* gain,
                                         const void* add, const float* coeffs, int P,
                                         float mean_scale, float eps, int* acc, void* out, int M,
                                         int N, int K, int drop_bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    run_scales<__nv_bfloat16>(x, w, hold, scales, M, K, N, eps_in, lev, lev2, st);
  else
    run_scales<float>(x, w, hold, scales, M, K, N, eps_in, lev, lev2, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_dispatch<true>(mul, in_bf16, x, w, scales, acc, M, N, K, drop_bits, lev, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;  // not launched: the accumulators are untouched
  finish_dispatch(out_bf16, acc, scales + k2::SC_SX + M, gain, add, coeffs, P, mean_scale, eps,
                  out, M, N, st);
  return (int)cudaGetLastError();
}

// Words of the scales buffer of vpu_quantize_matmul_fused for M rows.
extern "C" int vpu_scales_words(int M) { return k2::SC_SX + 2 * M; }

extern "C" const char* vpu_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
