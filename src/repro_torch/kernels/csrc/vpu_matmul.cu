// Multiplier-error contractions on Hopper: kernels K1 and K2.
//
// Replaces the Pallas TPU kernels repro/kernels/vpu_matmul.py:
//   elementwise_matmul        (_kernel)        -> vpu_matmul(),
//                                                 vpu_quantize_matmul_fused() at M > 4
//   elementwise_matmul_fused  (_fused_kernel)  -> vpu_quantize_matmul_fused() at M <= 4,
//                                                 vpu_matmul_fused()
// instantiated for the truncated multiplier (approx_mult.py) and the
// Mitchell logarithmic multiplier (log_matmul.py).  The serving entry,
// vpu_quantize_matmul_fused(), also takes in the operand quantisation that
// XLA fuses in front of the pallas_call on the TPU
// (repro/core/backends.py:_int_operand_quantize):
//   sx  = max(amax(|x|, row), eps)   sw = max(amax(|w|), eps)
//   xi  = round(clamp(x / sx, -1, 1) * levels), wi likewise with sw
//   pre = (sx * sw) / rnd(levels^2)
//   out = epilogue(rnd_out(float(sum_k mul(xi, wi)) * pre))
// every op rounded to the operand type as the plain version rounds it: the
// decode projection (K2, M <= 4) and, with an empty epilogue, the prefill
// projection (K1's function with the quantisation in front, M > 4).
// vpu_matmul() and vpu_matmul_fused() take integer-valued operands: the
// Pallas kernels' own interfaces.
//
// What bounds them on this card.  The Mitchell product is a nonlinear
// scalar function, on the CUDA cores: in integer arithmetic 7 instructions
// (K2) to 9.5 (the first K1, its SASS); as an add of float32 bit patterns
// (mitchell_f) an integer add, a LOP3 and an FADD, three instructions
// (SASS), none of whose pipes is busier than their dispatch.  The
// truncated product is not: with d dropped bits and r(v) = |v| mod 2^d,
// exactly
//   trunc(a b) = a b - sign(a) sign(b) ((r(a) r(b)) mod 2^d)
//              = sum_{j=0..15} A'_j(a) B'_j(b),
//   A' = (a, -sign(a) ((r(a) j) mod 2^d) for j = 1..15),
//   B' = (b, sign(b) [r(b) == j] for j = 1..15),
// an int8 dot product of 16 slots when |a|, |b| <= 127 and d <= 4.  So the
// truncated prefill contraction is an int8 tensor-core product over 16 K
// (2 M 16 K N operations: 0.023 ms at 64 x 2048 x 11008 at 1979 T/s)
// beside reading each bf16 weight once (0.013 ms).  At decode (M = 4)
// each weight is used 4 times and its two reads bound K2.
//
// Routes (K1's and the prefill's; M <= 4 of the quantised entry is K2):
// * Tensor cores: the truncated product, M > 4, operands of at most 7 bits
//   (|v| <= 127: the serving approx_mult, 7 bits) and d <= 4 dropped bits.
// * CUDA cores: the Mitchell product, and the truncated product with 8-bit
//   operands or d > 4 (2^d slots would outgrow the 3-instruction product,
//   and 255 does not fit s8).
// * M <= 4 rows, of either entry: K2's decode contraction.
//
// What the design does about it:
// * Operands are integers of at most 8 bits, so each product is computed
//   in integer arithmetic and summed in an int32 accumulator: exact, hence
//   independent of order, tile shape and split-K.  floor(log2) comes from
//   __clz, never from an approximate lg2.  No call launches a memset: the
//   decode contraction adds into accumulators that are zero on entry and
//   that its finishing pass clears after reading them; the prefill
//   contractions store each split's sums whole into a plane of their own,
//   which the finishing pass adds.
// * The scale pass reads x and w once: integer atomicMax of |v|'s bit
//   patterns (the max of non-negative floats is order-free); its last block
//   turns the maxima into sx, sw and pre, builds the level table (below),
//   and zeroes what it used.  On the tensor-core route the blocks of each x
//   row (one per 1024 activations), each of which takes the row's whole
//   max, quantise it and write its A' (16 bytes an activation; 2 MB at M =
//   64, K = 2048).
// * The level table.  Once sw is known, the level of a bf16 weight is a
//   function of its 16 bits: the scale pass quantises each bit pattern of
//   the 11 binades up to sw's (1408 patterns, __fdiv_rn and round-to-
//   nearest-even conversions, as the plain version rounds), and smaller
//   patterns quantise to 0.  The contractions find a weight's level by one
//   shared-memory load, not by ~20 instructions; float32 operands are
//   quantised one by one.
// * K2 (decode) streams each weight once, by 16-byte cp.async copies into
//   a ring of 4 stages of 8 rows; a block takes a 256-column tile, a lane
//   8 adjacent columns, and each of the 4 warps 2 rows of every stage.  The
//   stage's 32 activations are quantised by the 32 lanes and passed by
//   shuffles.  K is split across blocks (at most 32 a tile) to fill whole
//   waves of the card; the warps add their sums in shared memory and the
//   block adds them into int32 accumulators with atomics.  M > 4 of the
//   integer entry runs the contraction once per 4 rows (grid y).
// * The tensor-core contraction (mma_contract) streams A' and each weight
//   once per 64-row tile by cp.async into a 3-stage ring; a block of 4 warps
//   takes 64 rows x 256 columns, a warp 64 x 64 as 4 x 8 tiles of
//   mma.m16n8k32.s8.  A lane's B' bytes of 8 weights come from one 16-byte
//   load of 8 adjacent bf16 weights, each turned into its level by the
//   level table and into its 8 slot bytes by a 4 KB slot table (one
//   8-byte load), and feed 4 mma: a weight's slots are built once per 64
//   rows.  K is split across blocks to fill whole waves; each split stores
//   a plane of int32 sums (no atomics), which the finishing pass adds.
// * Per product in the decode contraction, from a weight's level |b|, sign
//   and 2^floor(log2 |b|): truncated, sign(b) * ((a |b| + (low & sign a)) &
//   ~low), the product rounded toward zero; Mitchell, mitchell().  Written
//   as sign(ab) * (|ab| & ~low) with |ab| = (ab ^ s) - s, as truncated()
//   reads, the truncated product compiles to IABS and ran 2.4x slower than
//   this form in the decode contraction (PERF.md), but 4% faster in the
//   CUDA-core prefill tile, which keeps it.
// * The CUDA-core prefill contraction (contract) keeps its shared-memory
//   tiles: each thread owns a 4 x 4 register tile of a 32 x 128 block, x
//   and w tiles are fetched into registers a tile ahead, quantised (the
//   weights through the level table) or rounded and staged in shared
//   memory, and K is split across blocks, each split storing a plane of
//   sums, when the output tiles alone cannot fill the SMs.  The
//   Mitchell product is mitchell_f() on staged (pattern, mask) pairs,
//   summed in float32 over 256 products at a time (exact: below 2^24),
//   then into the int32 sums.
// * Ragged M, N and K are masked in the kernels (zero operands give zero
//   products for both multipliers, and zero slots); there is no padding
//   copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

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

// The truncated product of signed integers: sign(ab) * floor(|ab| / 2^d)
// * 2^d, rounded toward zero (low = 2^d - 1).
__device__ __forceinline__ int truncated(int a, int b, int low) {
  const int p = a * b;
  const int s = p >> 31;  // 0 or -1
  const int mag = ((p ^ s) - s) & ~low;
  return (mag ^ s) - s;
}

// Mitchell's product of signed integers a and b, with |a| = 2^ka (1+ma),
// |b| = 2^kb (1+mb):
//   m = ma + mb < 1:  |a| 2^kb + |b| 2^ka - 2^(ka+kb)
//   otherwise:        2 (|a| 2^kb + |b| 2^ka) - 4 * 2^(ka+kb)
// With sign(ab) folded into S = a pb + b pa and T = pa pb (pa, pb the
// signed 2^floor(log2 |.|)), that is S - T plus S - 3T when S - 3T has T's
// sign or is 0.  From the weight's pb, b1 = b - pb and b3 = b - 3 pb:
// S - T = a pb + pa b1, S - 3T = a pb + pa b3, 7 instructions.
__device__ __forceinline__ int mitchell(int a, int pa, int pb, int b1, int b3) {
  const int ab = a * pb;
  const int u = pa * b1 + ab;
  const int d = pa * b3 + ab;
  return u + ((d ^ pa ^ pb) >= 0 ? d : 0);
}

// Mitchell's product is also the sum of float32 bit patterns: for integers
// a, b != 0 of at most 8 bits, with fa, fb their float32 patterns (sign,
// exponent 127 + k, mantissa m 2^23, exact),
//   fa + (fb - 0x3F800000) = sign(ab), exponent 127 + ka + kb, mantissa
//   (ma + mb) 2^23, or on a mantissa carry exponent 128 + ka + kb, mantissa
//   (ma + mb - 1) 2^23
// which is the float32 of Mitchell's product (an integer below 2^16), the
// signs added in the top bit.  Zero operands carry a zero mask.  So a
// product is one integer add and one mask (a LOP3), summed in float32,
// exact while the partial sums stay below 2^24: 256 products.
struct alignas(8) MitchellOp {
  int bits, mask;  // the pattern (a weight's less 0x3F800000); -1 for v != 0, else 0
};

template <bool WEIGHT>
__device__ __forceinline__ MitchellOp mitchell_op(int v) {
  return {__float_as_int(__int2float_rn(v)) - (WEIGHT ? 0x3F800000 : 0), v ? -1 : 0};
}

__device__ __forceinline__ float mitchell_f(MitchellOp a, MitchellOp b) {
  return __int_as_float((a.bits + b.bits) & a.mask & b.mask);
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

// The tensor-core route of K1 (the truncated product, prefill).
namespace k1 {
constexpr int S = 16;          // int8 slots of each k: the product, then 15 corrections
constexpr int MAX_DROP = 4;    // dropped bits it takes: r(b) < 2^4 = S
constexpr int MAX_BITS = 7;    // operand bits it takes: |a|, |b| <= 127 fit s8
constexpr int BM = 64;         // rows of a block: four m16 tiles, one prefill bucket
constexpr int WN = 64;         // columns of a warp: eight n8 tiles
constexpr int WARPS = 4;
constexpr int NT = WARPS * 32;
constexpr int BN = WARPS * WN; // columns of a block
constexpr int KS = 16;         // weight rows of a stage: 8 mma k-steps of 2 rows (32 slots)
constexpr int STAGES = 3;
constexpr int AROW = KS * S + 32;  // bytes of a stage's A' row: padded, so the fragment loads
                                   // of a half-warp (4 rows) fall in distinct banks
constexpr int BLOCKS_PER_SM = 2;
constexpr int MAX_SPLITS = 64;
constexpr int A_PART = 1024;   // activations of a row whose A' one scale-pass block writes

// K rounded up to whole stages: A' rows are that long, zero past K.
__host__ __device__ constexpr int padded_k(int K) { return (K + KS - 1) / KS * KS; }

// The slots of activation a, as 16 bytes: a, then for j = 1..15
// -sign(a) ((r(a) j) mod 2^d), r(a) = |a| mod 2^d (low = 2^d - 1).  With the
// weight's slots (b_slots), sum_j A'_j B'_j = a b - sign(ab) ((|a| |b|) mod
// 2^d) = the truncated product.
__device__ __forceinline__ uint4 a_slots(int a, int low) {
  const int r = abs(a) & low;
  const int s = a < 0 ? 1 : -1;
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int v = j == 0 ? a : s * ((r * j) & low);
    w[j / 4] |= (unsigned)(v & 0xff) << (8 * (j % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The slots of weight b: b, then for j = 1..15 sign(b) [r(b) == j].
__device__ __forceinline__ uint4 b_slots(int b, int low) {
  const int r = abs(b) & low;
  const int s = b < 0 ? -1 : 1;
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int v = j == 0 ? b : (r == j ? s : 0);
    w[j / 4] |= (unsigned)(v & 0xff) << (8 * (j % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
}  // namespace k1

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

// Where weight (k, n) lies: w [K, N] row-major (nk = 0), or w given as
// [N, K] row-major (nk = K).
__device__ __forceinline__ size_t w_index(int k, int n, int N, int nk) {
  return nk ? (size_t)n * nk + k : (size_t)k * N + n;
}
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
// multiple of the copy, a pointer not aligned for it, or w given as [N, K]),
// element loads.  nk: 0 for w [K, N] row-major; K for w given as [N, K]
// row-major (a tied LM head reads the embedding in place), whose element
// loads take consecutive rows of one column in consecutive threads.
template <typename T, bool VEC>
__device__ __forceinline__ void load_stage(Stage<T>& sg, const T* __restrict__ x,
                                           const T* __restrict__ w, int s0, int r1, int m0,
                                           int nb, int M, int N, int K, int tid, int nk) {
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
      const int rr = nk ? i % R : i / TW, c = nk ? i / R : i % TW, n = nb + c;
      sg.w[rr][c] = rr < rows && n < N ? w[w_index(s0 + rr, n, N, nk)] : T(0.0f);
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
                    int spb, int drop_bits, float lev, int nk) {
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
    if (s < n_st) load_stage<T, VEC>(ring[s], x, w, r0 + s * R, r1, m0, nb, M, N, K, tid, nk);
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
      load_stage<T, VEC>(ring[nx % STAGES], x, w, r0 + nx * R, r1, m0, nb, M, N, K, tid, nk);
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
        // Mitchell: mitchell() from the weight's pb, b - pb and b - 3 pb
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
          for (int h = 0; h < RPW; ++h) sum += mitchell(xa[h][m], xb[h][m], pb[h], b1[h], b3[h]);
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

// Grid and stages per split of a contraction of U stages over gx x gy
// output tiles: the split of K that keeps the most block slots of the card
// busy over whole waves, the fewer splits on a tie, each split at least 2
// stages long and at most max_splits of them.
struct SplitPlan {
  int gx, gy, gz, spb;
};

SplitPlan split_plan(int gx, int gy, int U, int blocks_per_sm, int max_splits) {
  SplitPlan p{gx, gy, 1, U};
  const long long base = (long long)gx * gy;
  const long long slots = (long long)repro_epi::sm_count() * blocks_per_sm;
  const int most = std::max(1, std::min({(U + 1) / 2, max_splits, (int)(4 * slots / base) + 1}));
  double best = -1.0;
  for (int splits = 1; splits <= most; ++splits) {
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
                   int drop_bits, float lev, int nk, cudaStream_t st) {
  using namespace k2;
  const SplitPlan p = split_plan((N + TW - 1) / TW, (M + BM - 1) / BM, (K + R - 1) / R,
                                 BLOCKS_PER_SM, MAX_SPLITS);
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
      x, w, scales, acc, M, N, K, p.spb, drop_bits, lev, nk);
}

template <int MUL, bool QUANT, typename T>
void run_decode(const void* x, const void* w, const float* scales, int* acc, int M, int N,
                int K, int drop_bits, float lev, int nk, cudaStream_t st) {
  // 16-byte copies of w rows and of x's R elements at a slot
  const bool vec = !nk && N % (16 / sizeof(T)) == 0 && K % k2::R == 0 && aligned(w, 16) &&
                   aligned(x, 16);
  constexpr bool TABLE = QUANT && sizeof(T) == 2;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  if (vec)
    launch_decode<MUL, QUANT, TABLE, T, true>(xt, wt, scales, acc, M, N, K, drop_bits, lev, 0,
                                              st);
  else
    launch_decode<MUL, QUANT, TABLE, T, false>(xt, wt, scales, acc, M, N, K, drop_bits, lev, nk,
                                               st);
}

template <bool QUANT>
void decode_dispatch(int mul, int in_bf16, const void* x, const void* w, const float* scales,
                     int* acc, int M, int N, int K, int drop_bits, float lev, int nk,
                     cudaStream_t st) {
  if (mul == MUL_APPROX) {
    if (in_bf16)
      run_decode<MUL_APPROX, QUANT, __nv_bfloat16>(x, w, scales, acc, M, N, K, drop_bits, lev,
                                                   nk, st);
    else
      run_decode<MUL_APPROX, QUANT, float>(x, w, scales, acc, M, N, K, drop_bits, lev, nk, st);
  } else {
    if (in_bf16)
      run_decode<MUL_MITCHELL, QUANT, __nv_bfloat16>(x, w, scales, acc, M, N, K, drop_bits,
                                                     lev, nk, st);
    else
      run_decode<MUL_MITCHELL, QUANT, float>(x, w, scales, acc, M, N, K, drop_bits, lev, nk,
                                             st);
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
// the weights; and zeroes hold.  With SLOTS (the tensor-core route of the
// truncated product) the x blocks come first, since they carry most of the
// pass's stores: row m has `parts` blocks, each of which takes the row's
// whole max, then quantises its share of the row (A_PART activations) and
// writes their A' slots (k1::a_slots), Kp per row, zero past K.  Without
// it (K2, the CUDA-core prefill) nothing of A' is compiled.
template <typename T, bool VEC, bool SLOTS>
__global__ void __launch_bounds__(k2::SCALE_NT)
    scale_pass(const T* __restrict__ x, const T* __restrict__ w, unsigned* __restrict__ hold,
               float* __restrict__ scales, uint4* __restrict__ aslots, int M, int K, int Kp,
               int parts, size_t KN, int wblocks, float eps, float lev, float lev2, int low) {
  using namespace k2;
  __shared__ unsigned red[SCALE_NT / 32];
  __shared__ bool last;
  const int tid = threadIdx.x;
  unsigned mx = 0u;
  // this block's index among the x blocks (xb) and among the w blocks (wb)
  const int xblocks = SLOTS ? M * parts : M;
  const int xb = (int)blockIdx.x - (SLOTS ? 0 : wblocks);
  const int wb = (int)blockIdx.x - (SLOTS ? xblocks : 0);
  const bool is_x = SLOTS ? xb < xblocks : xb >= 0;
  const int xm = SLOTS ? xb / parts : xb;  // x's row
  if (!is_x) {
    const size_t stride = (size_t)wblocks * SCALE_NT;
    size_t i = (size_t)wb * SCALE_NT + tid;
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
    const T* row = x + (size_t)xm * K;
    for (int k = tid; k < K; k += SCALE_NT) mx = max(mx, abs_bits(row[k]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(FULL, mx, o));
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
  // the block's max (with SLOTS every thread of an x block takes it)
  if (tid == 0 || (SLOTS && is_x)) {
#pragma unroll
    for (int j = SLOTS ? 0 : 1; j < SCALE_NT / 32; ++j) mx = max(mx, red[j]);
  }
  if (tid == 0) {
    atomicMax(is_x ? hold + 2 + xm : hold + 1, mx);
    __threadfence();  // the max lands before the count
    last = atomicAdd(hold, 1u) == gridDim.x - 1;
  }
  const unsigned eps_bits = __float_as_uint(eps);
  if constexpr (SLOTS) {
    if (is_x) {
      const float sx = __uint_as_float(max(mx, eps_bits));  // as the last block reads it
      const T* row = x + (size_t)xm * K;
      uint4* out = aslots + (size_t)xm * Kp;
      const int k0 = xb % parts * k1::A_PART, kend = min(Kp, k0 + k1::A_PART);
      for (int k = k0 + tid; k < kend; k += SCALE_NT)
        out[k] = k1::a_slots(k < K ? quantize<T>(to_f32(row[k]), sx, lev) : 0, low);
    }
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // every other block has added its max: read them, and leave hold zero
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

template <typename T, bool VEC>
void launch_scales(const T* x, const T* w, unsigned* hold, float* scales, uint4* aslots, int M,
                   int K, int Kp, int parts, size_t KN, int wblocks, float eps, float lev,
                   float lev2, int low, cudaStream_t st) {
  const int blocks = wblocks + M * parts;
  if (aslots)
    scale_pass<T, VEC, true><<<blocks, k2::SCALE_NT, 0, st>>>(
        x, w, hold, scales, aslots, M, K, Kp, parts, KN, wblocks, eps, lev, lev2, low);
  else
    scale_pass<T, VEC, false><<<blocks, k2::SCALE_NT, 0, st>>>(
        x, w, hold, scales, aslots, M, K, Kp, parts, KN, wblocks, eps, lev, lev2, low);
}

template <typename T>
void run_scales(const void* x, const void* w, unsigned* hold, float* scales, uint4* aslots,
                int M, int K, int N, float eps, float lev, float lev2, int drop_bits,
                cudaStream_t st) {
  const size_t KN = (size_t)K * N;
  const bool vec = KN * sizeof(T) % 16 == 0 && aligned(w, 16);
  const size_t per_block = (size_t)k2::SCALE_NT * (vec ? 4 * 16 / sizeof(T) : 4);
  const int wblocks =
      (int)std::max<size_t>(1, std::min<size_t>((KN + per_block - 1) / per_block,
                                                (size_t)repro_epi::sm_count() * 8));
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const int Kp = k1::padded_k(K), low = (1 << drop_bits) - 1;
  const int parts = aslots ? (Kp + k1::A_PART - 1) / k1::A_PART : 1;
  if (vec)
    launch_scales<T, true>(xt, wt, hold, scales, aslots, M, K, Kp, parts, KN, wblocks, eps, lev,
                           lev2, low, st);
  else
    launch_scales<T, false>(xt, wt, hold, scales, aslots, M, K, Kp, parts, KN, wblocks, eps, lev,
                            lev2, low, st);
}

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

// The prefill contractions take integer-valued operands (the reference
// kernel's interface), rounded to the nearest integer, or (QUANT) the
// operands themselves, quantised with the scale pass's sx (per row) and
// sw, the bf16 weights through its level table (tab, in shared memory,
// from pattern base).

// A weight's signed level from the level table entry of its bf16 pattern.
__device__ __forceinline__ int table_level(unsigned bits, const unsigned short* tab, int base) {
  const int s = -(int)(bits >> 15);
  return ((int)(tab[max((int)(bits & 0x7fffu) - base, 0)] & 0xffu) ^ s) - s;
}

template <bool QUANT, typename T>
__device__ __forceinline__ int weight_level(T v, const unsigned short* tab, int base, float sw,
                                            float lev) {
  if constexpr (QUANT && sizeof(T) == 2)
    return table_level(__bfloat16_as_ushort(v), tab, base);
  else
    return operand<QUANT, T>(to_f32(v), sw, lev);
}

// The CUDA-core contraction (the Mitchell product at any operand width, and
// the truncated product outside the tensor-core route): each thread owns a
// TM x TN register tile; x and w tiles are quantised (QUANT) or rounded on
// load and staged in shared memory as integers (truncated) or Mitchell
// operands (mitchell_op); K is split across blocks (a plane of int32 sums
// each) when the output tiles alone cannot fill the SMs.
namespace kc {
constexpr int BM = 32, BN = 128, BK = 16;  // a block's rows, columns and weight rows of a tile
constexpr int TM = 4, TN = 4;              // a thread's rows and columns
constexpr int TX = BN / TN;                // threads along N
constexpr int NT = (BM / TM) * TX;
constexpr int BLOCKS_PER_SM = 2;  // at most 128 registers a thread (Mitchell's float and int sums)
}  // namespace kc

template <int MUL, bool QUANT, typename T>
__global__ void __launch_bounds__(kc::NT, kc::BLOCKS_PER_SM)
    contract(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ scales,
             int* __restrict__ planes, int M, int N, int K, int k_split, int drop_bits,
             float lev, int nk) {
  using namespace kc;
  constexpr bool LOG = MUL == MUL_MITCHELL;
  constexpr bool TABLE = QUANT && sizeof(T) == 2;
  // operands as integers (truncated) or Mitchell operands
  using Op = std::conditional_t<LOG, MitchellOp, int>;
  __shared__ Op xs[BK][BM + 1];
  __shared__ Op ws[BK][BN];
  __shared__ unsigned short tab[TABLE ? k2::TAB : 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_split;
  const int ke = min(K, kb + k_split);
  const int low = (1 << drop_bits) - 1;  // the truncated product's dropped bits
  float sw = 1.0f;
  int base = 0;
  if constexpr (QUANT) {
    sw = scales[k2::SC_SW];
    if constexpr (TABLE) {
      base = __float_as_int(scales[k2::SC_BASE]);
      const unsigned short* t = reinterpret_cast<const unsigned short*>(scales);
      for (int i = tid; i < k2::TAB; i += NT) tab[i] = t[i];
    }
  }

  // the sums: int32, and for Mitchell float32 over at most CHUNK products
  // (BK of each of CHUNK / BK tiles), added into the int32 sums after each
  constexpr int CHUNK = 256;
  static_assert(CHUNK % BK == 0, "whole tiles a chunk");
  int a[TM][TN];
  float f[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) a[i][j] = 0, f[i][j] = 0.0f;

  // a tile's operands as loaded, zero past the range (zero operands give
  // zero products): fetched into registers a tile ahead, so their loads are
  // in flight during the products of the tile before
  constexpr int XPT = BM * BK / NT, WPT = BK * BN / NT;
  static_assert(XPT * NT == BM * BK && WPT * NT == BK * BN, "whole tiles a thread");
  T xr[XPT], wr[WPT];
  float sxr[XPT];
  // element i of the w tile: (row, column) = (i / BN, i % BN), or for w
  // given as [N, K] (i % BK, i / BK), consecutive rows of one column in
  // consecutive threads
  auto w_row = [&](int i) { return nk ? i % BK : i / BN; };
  auto w_col = [&](int i) { return nk ? i / BK : i % BN; };
  auto fetch = [&](int k0) {
#pragma unroll
    for (int r = 0; r < XPT; ++r) {
      const int i = tid + r * NT, gm = m0 + i / BK, gk = k0 + i % BK;
      const bool ok = gm < M && gk < ke;
      xr[r] = ok ? x[(size_t)gm * K + gk] : T(0.0f);
      sxr[r] = QUANT && ok ? scales[k2::SC_SX + gm] : 1.0f;
    }
#pragma unroll
    for (int r = 0; r < WPT; ++r) {
      const int i = tid + r * NT, gk = k0 + w_row(i), gn = n0 + w_col(i);
      wr[r] = gk < ke && gn < N ? w[w_index(gk, gn, N, nk)] : T(0.0f);
    }
  };

  fetch(kb);
  for (int k0 = kb; k0 < ke; k0 += BK) {
    __syncthreads();  // the table is in; every thread is done with the last tiles
#pragma unroll
    for (int r = 0; r < XPT; ++r) {
      const int i = tid + r * NT;
      const int v = operand<QUANT, T>(to_f32(xr[r]), sxr[r], lev);
      if constexpr (LOG)
        xs[i % BK][i / BK] = mitchell_op<false>(v);
      else
        xs[i % BK][i / BK] = v;
    }
#pragma unroll
    for (int r = 0; r < WPT; ++r) {
      const int i = tid + r * NT;
      const int v = weight_level<QUANT, T>(wr[r], tab, base, sw, lev);
      if constexpr (LOG)
        ws[w_row(i)][w_col(i)] = mitchell_op<true>(v);
      else
        ws[w_row(i)][w_col(i)] = v;
    }
    __syncthreads();
    if (k0 + BK < ke) fetch(k0 + BK);
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      Op av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = ws[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if constexpr (LOG)
            f[i][j] += mitchell_f(av[i], bv[j]);
          else
            a[i][j] += truncated(av[i], bv[j], low);
        }
    }
    if (LOG && ((k0 - kb + BK) % CHUNK == 0 || k0 + BK >= ke)) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) a[i][j] += __float2int_rn(f[i][j]), f[i][j] = 0.0f;
    }
  }

  int* plane = planes + (size_t)blockIdx.z * M * N;  // split z's sums
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn < N) plane[(size_t)gm * N + gn] = a[i][j];
    }
  }
}

// Splits of K of the CUDA-core contraction: about two blocks per SM in
// flight; spb tiles each.
SplitPlan core_plan(int M, int N, int K) {
  using namespace kc;
  SplitPlan p{(N + BN - 1) / BN, (M + BM - 1) / BM, 1, (K + BK - 1) / BK};
  const int want = (2 * repro_epi::sm_count() + p.gx * p.gy - 1) / (p.gx * p.gy);
  const int parts = std::min(p.spb, std::max(1, want));
  p.spb = (p.spb + parts - 1) / parts;
  p.gz = ((K + BK - 1) / BK + p.spb - 1) / p.spb;
  return p;
}

template <int MUL, bool QUANT, typename T>
void run_contract(const void* x, const void* w, const float* scales, int* planes, int M, int N,
                  int K, int drop_bits, float lev, int nk, cudaStream_t st) {
  const SplitPlan p = core_plan(M, N, K);
  contract<MUL, QUANT, T><<<dim3(p.gx, p.gy, p.gz), kc::NT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scales, planes, M, N, K,
      p.spb * kc::BK, drop_bits, lev, nk);
}

template <bool QUANT>
void contract_dispatch(int mul, int in_bf16, const void* x, const void* w, const float* scales,
                       int* acc, int M, int N, int K, int drop_bits, float lev, int nk,
                       cudaStream_t st) {
  if (mul == MUL_APPROX) {
    if (in_bf16)
      run_contract<MUL_APPROX, QUANT, __nv_bfloat16>(x, w, scales, acc, M, N, K, drop_bits, lev,
                                                     nk, st);
    else
      run_contract<MUL_APPROX, QUANT, float>(x, w, scales, acc, M, N, K, drop_bits, lev, nk, st);
  } else {
    if (in_bf16)
      run_contract<MUL_MITCHELL, QUANT, __nv_bfloat16>(x, w, scales, acc, M, N, K, drop_bits, lev,
                                                       nk, st);
    else
      run_contract<MUL_MITCHELL, QUANT, float>(x, w, scales, acc, M, N, K, drop_bits, lev, nk,
                                               st);
  }
}

// The tensor-core route: rows M > 4 of the truncated product with operands
// of at most 7 bits and at most 4 dropped bits.
bool tc_route(int mul, int M, int bits, int drop_bits) {
  return mul == MUL_APPROX && M > k2::BM && bits <= k1::MAX_BITS && drop_bits >= 0 &&
         drop_bits <= k1::MAX_DROP;
}

// One stage of the tensor-core contraction's ring: A' of the block's 64
// rows at KS weight rows (16 slots each), and those rows of w at the
// block's 256 columns (rows padded by 32 bytes: the fragment loads of a
// quarter-warp, 2 rows x 2 column groups, fall in distinct banks).
template <typename T>
struct MmaStage {
  alignas(16) signed char a[k1::BM][k1::AROW];
  alignas(16) T w[k1::KS][k1::BN + 32 / sizeof(T)];
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Stage rows [s0, s0 + KS) of the split's range [.., r1): A' by 16-byte
// cp.async copies (zero-filled past M; A' rows are zero past K); w by
// 16-byte copies with VEC (zero-filled past r1 and N), else element loads
// (nk as for load_stage).
template <typename T, bool VEC>
__device__ __forceinline__ void load_mma_stage(MmaStage<T>& sg, const uint4* __restrict__ aslots,
                                               const T* __restrict__ w, int s0, int r1, int m0,
                                               int n0, int M, int N, int Kp, int tid, int nk) {
  using namespace k1;
  constexpr int AC = KS * S / 16;  // copies of an A' row
  for (int i = tid; i < BM * AC; i += NT) {
    const int r = i / AC, c = i % AC;
    const bool ok = m0 + r < M;
    cp_async16(&sg.a[r][16 * c], aslots + (ok ? (size_t)(m0 + r) * Kp + s0 + c : 0), ok ? 16 : 0);
  }
  if constexpr (VEC) {
    constexpr int CE = 16 / sizeof(T);
    for (int i = tid; i < KS * BN / CE; i += NT) {
      const int rr = i / (BN / CE), j = i % (BN / CE);
      const int n = n0 + j * CE;
      const bool ok = s0 + rr < r1 && n < N;
      cp_async16(&sg.w[rr][j * CE], w + (ok ? (size_t)(s0 + rr) * N + n : 0), ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < KS * BN; i += NT) {
      const int rr = nk ? i % KS : i / BN, c = nk ? i / KS : i % BN, n = n0 + c;
      sg.w[rr][c] = s0 + rr < r1 && n < N ? w[w_index(s0 + rr, n, N, nk)] : T(0.0f);
    }
  }
}

// Block (x, y, z): columns [256 x, 256 x + 256), rows [64 y, 64 y + 64),
// weight rows [r0, r1) of split z, spb stages each.  Warp v takes columns
// [64 v, 64 v + 64) and all 64 rows: 4 m16 x 8 n8 tiles of
// mma.m16n8k32.s8, an mma k-step covering 2 weight rows of 16 slots.  Lane
// (g, t) = (lane / 4, lane % 4) holds, at each k-step, slots 8 (t & 1) ..
// + 7 of weight row t / 2: the A' bytes of rows g and g + 8 of each m16
// tile (one 8-byte load each) and, for n8 tile c, the B' bytes of column 8
// g + c (so a lane's 8 weights of a k-step are one 16-byte load), looked up
// by the weight's level in the block's slot table.  The mma's column q of
// tile c is column 8 q + c of the warp: a lane's sums are 16 adjacent
// columns of each of its rows.
template <bool QUANT, typename T, bool VEC>
__global__ void __launch_bounds__(k1::NT, k1::BLOCKS_PER_SM)
    mma_contract(const uint4* __restrict__ aslots, const T* __restrict__ w,
                 const float* __restrict__ scales, int* __restrict__ planes, int M, int N, int K,
                 int spb, int drop_bits, float lev, int nk) {
  using namespace k1;
  constexpr bool TABLE = QUANT && sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  MmaStage<T>* ring = reinterpret_cast<MmaStage<T>*>(smem);
  uint2* slot = reinterpret_cast<uint2*>(smem + STAGES * sizeof(MmaStage<T>));  // [256][2]
  unsigned short* tab = reinterpret_cast<unsigned short*>(slot + 2 * 256);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, half = t & 1;
  const int Kp = padded_k(K);
  const int r0 = blockIdx.z * spb * KS, r1 = min(K, r0 + spb * KS);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_st = (r1 - r0 + KS - 1) / KS;
  const int low = (1 << drop_bits) - 1;

  if constexpr (TABLE) {  // the level table, in the first copy group
    for (int i = tid; i < k2::TAB * 2 / 16; i += NT) cp_async16(tab + 8 * i, scales + 4 * i, 16);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_st) load_mma_stage<T, VEC>(ring[s], aslots, w, r0 + s * KS, r1, m0, n0, M, N, Kp, tid,
                                        nk);
    cp_async_commit();
  }
  // the slot table: entry b + 128 is b_slots(b), its two 8-byte halves
  for (int e = tid; e < 256; e += NT) {
    const uint4 v = b_slots(e - 128, low);
    slot[2 * e] = make_uint2(v.x, v.y);
    slot[2 * e + 1] = make_uint2(v.z, v.w);
  }
  float sw = 1.0f;
  int base = 0;
  if constexpr (QUANT) {
    sw = scales[k2::SC_SW];
    base = __float_as_int(scales[k2::SC_BASE]);
  }

  int c[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[i][j][q] = 0;

  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage st has landed; every warp is done with stage st - 1
    const int nx = st + STAGES - 1;
    if (nx < n_st)
      load_mma_stage<T, VEC>(ring[nx % STAGES], aslots, w, r0 + nx * KS, r1, m0, n0, M, N, Kp, tid,
                             nk);
    cp_async_commit();

    const MmaStage<T>& sg = ring[st % STAGES];
#pragma unroll 2
    for (int ks = 0; ks < KS / 2; ++ks) {
      const int kl = 2 * ks + (t >> 1);
      unsigned af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint2 lo = *reinterpret_cast<const uint2*>(&sg.a[16 * i + g][S * kl + 8 * half]);
        const uint2 hi = *reinterpret_cast<const uint2*>(&sg.a[16 * i + g + 8][S * kl + 8 * half]);
        af[i][0] = lo.x, af[i][1] = hi.x, af[i][2] = lo.y, af[i][3] = hi.y;
      }
      const T* wr = &sg.w[kl][WN * warp + 8 * g];
      int b[8];
      if constexpr (sizeof(T) == 2) {
        const uint4 q = *reinterpret_cast<const uint4*>(wr);
        const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const unsigned bits = j & 1 ? u[j / 2] >> 16 : u[j / 2] & 0xffffu;
          if constexpr (TABLE)
            b[j] = table_level(bits, tab, base);
          else
            b[j] = operand<QUANT, T>(__uint_as_float(bits << 16), sw, lev);
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 q = reinterpret_cast<const float4*>(wr)[h];
          b[4 * h + 0] = operand<QUANT, T>(q.x, sw, lev);
          b[4 * h + 1] = operand<QUANT, T>(q.y, sw, lev);
          b[4 * h + 2] = operand<QUANT, T>(q.z, sw, lev);
          b[4 * h + 3] = operand<QUANT, T>(q.w, sw, lev);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint2 bf = slot[2 * (b[j] + 128) + half];
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_s8(c[i][j], af[i], bf);
      }
    }
  }
  cp_async_wait<0>();

  // lane (g, t) holds rows 16 i + g (+ 8) at columns 16 t + 8 h + j of the
  // warp: c[i][j][2 * hr + h], stored into split z's plane
  int* plane = planes + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + 16 * i + g + 8 * hr;
      if (m >= M) continue;
      const int n = n0 + WN * warp + 16 * t;
      int* row = plane + (size_t)m * N;
      if (n + 16 <= N && (N & 3) == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            *reinterpret_cast<int4*>(row + n + 8 * h + 4 * q) =
                make_int4(c[i][4 * q][2 * hr + h], c[i][4 * q + 1][2 * hr + h],
                          c[i][4 * q + 2][2 * hr + h], c[i][4 * q + 3][2 * hr + h]);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (n + 8 * h + j < N) row[n + 8 * h + j] = c[i][j][2 * hr + h];
      }
    }
  }
}

SplitPlan mma_plan(int M, int N, int K) {
  using namespace k1;
  return split_plan((N + BN - 1) / BN, (M + BM - 1) / BM, (K + KS - 1) / KS, BLOCKS_PER_SM,
                    MAX_SPLITS);
}

template <bool QUANT, typename T, bool VEC>
void launch_mma(const uint4* aslots, const T* w, const float* scales, int* planes, int M, int N,
                int K, int drop_bits, float lev, int nk, cudaStream_t st) {
  using namespace k1;
  const SplitPlan p = mma_plan(M, N, K);
  const int smem = STAGES * (int)sizeof(MmaStage<T>) + 256 * 16 + k2::TAB * 2;
  static bool attr = [smem] {
    cudaFuncSetAttribute(mma_contract<QUANT, T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    cudaFuncSetAttribute(mma_contract<QUANT, T, VEC>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    return true;
  }();
  (void)attr;
  mma_contract<QUANT, T, VEC><<<dim3(p.gx, p.gy, p.gz), NT, smem, st>>>(
      aslots, w, scales, planes, M, N, K, p.spb, drop_bits, lev, nk);
}

template <bool QUANT, typename T>
void run_mma(const uint4* aslots, const void* w, const float* scales, int* planes, int M, int N,
             int K, int drop_bits, float lev, int nk, cudaStream_t st) {
  const bool vec = !nk && N % (16 / sizeof(T)) == 0 && aligned(w, 16);
  const T* wt = static_cast<const T*>(w);
  if (vec)
    launch_mma<QUANT, T, true>(aslots, wt, scales, planes, M, N, K, drop_bits, lev, 0, st);
  else
    launch_mma<QUANT, T, false>(aslots, wt, scales, planes, M, N, K, drop_bits, lev, nk, st);
}

template <bool QUANT>
void mma_dispatch(int in_bf16, const uint4* aslots, const void* w, const float* scales, int* acc,
                  int M, int N, int K, int drop_bits, float lev, int nk, cudaStream_t st) {
  if (in_bf16)
    run_mma<QUANT, __nv_bfloat16>(aslots, w, scales, acc, M, N, K, drop_bits, lev, nk, st);
  else
    run_mma<QUANT, float>(aslots, w, scales, acc, M, N, K, drop_bits, lev, nk, st);
}

// The contraction for M rows: K2's decode contraction at M <= 4, else the
// tensor-core route (aslots: A' written) or the CUDA-core prefill
// contraction.  nk: 0 for w [K, N], K for w given as [N, K].
template <bool QUANT>
void contract_rows(int mul, int in_bf16, const void* x, const void* w, const uint4* aslots,
                   const float* scales, int* acc, int M, int N, int K, int bits, int drop_bits,
                   float lev, int nk, cudaStream_t st) {
  if (M <= k2::BM)
    decode_dispatch<QUANT>(mul, in_bf16, x, w, scales, acc, M, N, K, drop_bits, lev, nk, st);
  else if (tc_route(mul, M, bits, drop_bits))
    mma_dispatch<QUANT>(in_bf16, aslots, w, scales, acc, M, N, K, drop_bits, lev, nk, st);
  else
    contract_dispatch<QUANT>(mul, in_bf16, x, w, scales, acc, M, N, K, drop_bits, lev, nk, st);
}

// A' of integer-valued activations (K1's integer entry): row m of x as
// Kp slot vectors, zero past K.
template <typename T>
__global__ void expand_slots(const T* __restrict__ x, uint4* __restrict__ aslots, int M, int K,
                             int Kp, int low) {
  const size_t n = (size_t)M * Kp;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(i / Kp), k = (int)(i % Kp);
    aslots[i] = k1::a_slots(k < K ? __float2int_rn(repro_epi::load<T>(x, (size_t)m * K + k)) : 0,
                            low);
  }
}

using repro_epi::grid_for;

// The int32 sum of output i: the accumulator of the decode contraction,
// zeroed after its read, ready for the next call (ClearedSum), or the sum
// over the split planes of a prefill contraction (PlaneSum: written whole,
// nothing to clear).
struct ClearedSum {
  int* acc;
  __device__ int operator()(size_t i) const { return acc[i]; }
  __device__ void release(size_t i) const { acc[i] = 0; }
};

struct PlaneSum {
  const int* acc;
  int planes;
  size_t n;  // outputs of a plane
  __device__ int operator()(size_t i) const {
    int s = 0;
    for (int z = 0; z < planes; ++z) s += acc[z * n + i];
    return s;
  }
};

// K1's finishing pass: the int32 sums as float32.
template <typename Sum>
__global__ void to_float(Sum sum, float* __restrict__ out, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    out[i] = __int2float_rn(sum(i));
    repro_epi::release(sum, i);
  }
}

// The value before the epilogue: the int32 sum times the row's prescale,
// rounded to the output type, releasing the sum after its last read.
template <typename T, typename Sum>
struct ScaledSum {
  Sum sum;
  const float* pre;
  __device__ float operator()(size_t i, int m) const {
    return repro_epi::rnd<T>(__fmul_rn(__int2float_rn(sum(i)), pre[m]));
  }
  __device__ void release(size_t i) const { repro_epi::release(sum, i); }
};

template <typename Sum>
void finish_dispatch(int out_bf16, Sum sum, const float* pre, const void* gain, const void* add,
                     const float* coeffs, int P, float eps, void* out, int M,
                     int N, cudaStream_t st) {
  if (out_bf16)
    repro_epi::finish<__nv_bfloat16>(ScaledSum<__nv_bfloat16, Sum>{sum, pre}, gain, add, coeffs,
                                     P, eps, out, M, N, st);
  else
    repro_epi::finish<float>(ScaledSum<float, Sum>{sum, pre}, gain, add, coeffs, P, eps,
                             out, M, N, st);
}

// Split planes a prefill contraction writes for these arguments (0 for the
// decode contraction, M <= 4: its accumulators are added into and cleared).
int plane_count(int mul, int M, int N, int K, int bits, int drop_bits) {
  if (M <= k2::BM) return 0;
  return tc_route(mul, M, bits, drop_bits) ? mma_plan(M, N, K).gz : core_plan(M, N, K).gz;
}

}  // namespace
}  // namespace repro_vpu

using namespace repro_vpu;

// K1: out[M,N] (float32) = sum_k mul(x[m,k], w[k,n]).  x, w: integer-valued
// float32 or bfloat16 of at most `bits` bits (|v| <= 2^bits - 1), row-major;
// acc: int32 [M,N], all zero on entry and left all zero (M <= 4), or
// vpu_plane_count(...) planes of [M,N] (any contents); aslots:
// vpu_slot_words(...) 16-byte words of scratch (the tensor-core route's A').
// The tensor-core route is three launches (A', the contraction, the
// conversion), the CUDA-core route two.
extern "C" int vpu_matmul(int mul, int in_bf16, const void* x, const void* w, void* aslots,
                          int* acc, float* out, int M, int N, int K, int bits, int drop_bits,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint4* a = static_cast<uint4*>(aslots);
  if (tc_route(mul, M, bits, drop_bits)) {
    const int Kp = k1::padded_k(K), low = (1 << drop_bits) - 1;
    if (in_bf16)
      expand_slots<<<grid_for((size_t)M * Kp, 256), 256, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), a, M, K, Kp, low);
    else
      expand_slots<<<grid_for((size_t)M * Kp, 256), 256, 0, st>>>(static_cast<const float*>(x),
                                                                  a, M, K, Kp, low);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  contract_rows<false>(mul, in_bf16, x, w, a, nullptr, acc, M, N, K, bits, drop_bits, 0.0f, 0,
                       st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;  // not launched: the accumulators are untouched
  const size_t n = (size_t)M * N;
  const int planes = plane_count(mul, M, N, K, bits, drop_bits);
  if (planes)
    to_float<<<grid_for(n, 256), 256, 0, st>>>(PlaneSum{acc, planes, n}, out, n);
  else
    to_float<<<grid_for(n, 256), 256, 0, st>>>(ClearedSum{acc}, out, n);
  return (int)cudaGetLastError();
}

// 16-byte words of A' scratch that vpu_matmul and vpu_quantize_matmul_fused
// need for these arguments (0 off the tensor-core route).
extern "C" int vpu_slot_words(int mul, int M, int K, int bits, int drop_bits) {
  return tc_route(mul, M, bits, drop_bits) ? M * k1::padded_k(K) : 0;
}

// Split planes of M x N int32 sums that vpu_matmul and
// vpu_quantize_matmul_fused write into acc at M > 4 (need not be zero on
// entry); 0 at M <= 4 (acc: M x N, zero on entry and left so).
extern "C" int vpu_plane_count(int mul, int M, int N, int K, int bits, int drop_bits) {
  return plane_count(mul, M, N, K, bits, drop_bits);
}

// K2 on integer-valued operands (the Pallas kernel's interface): the
// contraction, then (acc * pre[m]) cast to the output type, then the
// epilogue: chip term when add != NULL (gain may be NULL: fault family),
// then the correction polynomial when P > 0.  gain/add are in the output
// type.  acc: int32 [M,N], all zero on entry, and left all zero.  Two
// launches.
extern "C" int vpu_matmul_fused(int mul, int in_bf16, int out_bf16, const void* x, const void* w,
                                const float* pre, const void* gain, const void* add,
                                const float* coeffs, int P, float eps, int* acc,
                                void* out, int M, int N, int K, int drop_bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  decode_dispatch<false>(mul, in_bf16, x, w, nullptr, acc, M, N, K, drop_bits, 0.0f, 0, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;  // not launched: the accumulators are untouched
  finish_dispatch(out_bf16, ClearedSum{acc}, pre, gain, add, coeffs, P, eps, out, M,
                  N, st);
  return (int)cudaGetLastError();
}

// K2 on the operands themselves, x [M,K] and w [K,N] in float32 or
// bfloat16 (w_nk = 1: w given as its transpose [N,K] row-major, read in
// place, as a tied LM head reads the embedding): the scale pass, the contraction of the operands quantised to
// +-lev (lev = 2^bits - 1, lev2 = lev^2 rounded to the operand type, eps
// = 1e-6 in it), then the prescale, the cast and the epilogue as in
// vpu_matmul_fused.  hold: 2 + M words and acc: int32 [M,N], all zero on
// entry and left all zero (acc at M > 4: as vpu_matmul's);
// scales: vpu_scales_words(M) words, written (the bf16 weights' level
// table, sw, sx[M], pre[M]); aslots: vpu_slot_words 16-byte words, written
// by the scale pass on the tensor-core route.  Rows
// M <= 4 take the decode contraction, more rows a prefill contraction (the
// tensor-core route or the CUDA-core one).  Three launches.
extern "C" int vpu_quantize_matmul_fused(int mul, int in_bf16, int out_bf16, const void* x,
                                         const void* w, unsigned* hold, float* scales,
                                         void* aslots, int bits, float lev, float lev2,
                                         float eps_in, const void* gain, const void* add,
                                         const float* coeffs, int P, float eps,
                                         int* acc, void* out, int M, int N, int K, int drop_bits,
                                         int w_nk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint4* a = tc_route(mul, M, bits, drop_bits) ? static_cast<uint4*>(aslots) : nullptr;
  if (in_bf16)
    run_scales<__nv_bfloat16>(x, w, hold, scales, a, M, K, N, eps_in, lev, lev2, drop_bits, st);
  else
    run_scales<float>(x, w, hold, scales, a, M, K, N, eps_in, lev, lev2, drop_bits, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  contract_rows<true>(mul, in_bf16, x, w, a, scales, acc, M, N, K, bits, drop_bits, lev,
                      w_nk ? K : 0, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;  // not launched: the accumulators are untouched
  const float* pre = scales + k2::SC_SX + M;
  const int planes = plane_count(mul, M, N, K, bits, drop_bits);
  if (planes)
    finish_dispatch(out_bf16, PlaneSum{acc, planes, (size_t)M * N}, pre, gain, add, coeffs, P,
                    eps, out, M, N, st);
  else
    finish_dispatch(out_bf16, ClearedSum{acc}, pre, gain, add, coeffs, P, eps, out,
                    M, N, st);
  return (int)cudaGetLastError();
}

// Words of the scales buffer of vpu_quantize_matmul_fused for M rows.
extern "C" int vpu_scales_words(int M) { return k2::SC_SX + 2 * M; }

extern "C" const char* vpu_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
