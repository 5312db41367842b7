// Analog-array contractions with ADC partial-sum quantisation on Hopper:
// kernels K6 and K7, both on the float64 tensor cores.
//
// Replaces the Pallas TPU kernels repro/kernels/analog_matmul.py:
//   analog_matmul        (_kernel, _adc_quantize) -> analog_matmul()
//   analog_matmul_fused  (_fused_kernel)          -> analog_matmul_fused()
//
// What is computed: the unipolar product of x [M, 2K] with a plane of 2K
// rows given as two [K, N] halves, read in place, with the 2K ports cut into
// arrays of array_size.  Each array's partial sum is clamped to
// [0, adc_range], scaled to 2^adc_bits - 1 levels, rounded half to even,
// scaled back and min'd with adc_range; the quantised partial sums are added
// in float32, array by array in order.  K6 does this for the plane
// [wa; wb].  K7 does it for both polarities, w_pos = [wp; wn] and
// w_neg = [wn; wp], subtracts the two sums (sum(adc_p) - sum(adc_n), not
// sum(adc_p - adc_n)), rescales, casts and runs the epilogue.
//
// Exactness.  The emulator feeds bf16 operands in [0, 1] from
// fake_quant_unipolar: every one is a multiple of 2^-15 (the largest
// integer multiple at 8 bits is 32768), so a product of two is a multiple
// of 2^-30 below 1 and an array's sum of up to 128 products is a multiple
// of 2^-30 below 2^7, which float64 holds exactly.  Each array's partial
// sum is therefore accumulated in float64, in any order and in any number
// of pieces, and rounded once to float32: its value does not depend on the
// order, tile, thread or warp that computed it, and the kernels are bitwise
// equal to their plain versions (a float64 matmul per array).  float32
// operands (tests only) take the same code; their products need more bits
// than float64 has, so there the argument is that of any two float64 sums
// rounded to float32.  The ADC rounds every op as written (__fdiv_rn,
// __fmul_rn, rintf, fminf): no multiply-add is contracted, so a level
// decision cannot move by an ulp.  No TF32, no bf16 tensor cores and no
// float32 sum inside an array: a partial sum that crosses an ADC level
// would change the result.  The quantised values of the arrays are not
// order-free (ADC levels are 4 fl(k/15)), so they are added in array
// order, per polarity, and the difference is taken once at the end.
//
// K7 (the analog decode matmul, M = 4 at serving).  What bounds it on this
// card: the bytes of the two bf16 weight halves (90 MB at 2048 x 11008,
// 27 us at 3.35 TB/s); the float64 products (2 polarities x 2 ports x M
// per weight pair, 360 M at 2048 x 11008) take ~11 us on the float64
// tensor cores and twice that on the CUDA cores.  What the design does:
//   * Each weight pair (wp[r, n], wn[r, n]) is read from device memory once
//     per M-tile and feeds the four sums it belongs to: port r of both
//     polarities (x[m, r] wp, x[m, r] wn) and port r + K of both
//     (x[m, r+K] wn for w_pos, x[m, r+K] wp for w_neg).  One m16n8k4
//     float64 mma takes 16 columns x 4 rows of one half as A and x at ports
//     r..r+3 and r+K..r+K+3 as the 8 columns of B, so its C holds the top
//     array's sum of one polarity and the bottom array's of the other.
//   * Every warp streams its own rows of a 64-column tile through a ring of
//     4 stages of 16 rows in shared memory (swizzled so an mma step reads
//     without bank conflicts), filled by 16-byte cp.async copies: three
//     stages are in flight while one is multiplied, and a warp needs no
//     block barrier.  The 4 warps of a block take adjacent tiles of the
//     same rows, so a block reads 512 contiguous bytes of each row.
//   * Warps (and blocks along z) take disjoint whole arrays: a unit is one
//     array's rows of each half when K is a multiple of array_size, and the
//     units per warp are chosen to fill whole waves of the card.  When both
//     arrays of a step end, the whole warp stores their rounded ADC levels
//     as byte codes (wider above 8 ADC bits), [2][C][M][N].  The finishing
//     pass adds each output's levels in array order, subtracts, rescales,
//     casts and runs the epilogue: two launches a call.  Without chip
//     terms (the serving path) it is finish_sums, which stages a block's
//     codes in shared memory by 16-byte loads and reads levels from a
//     table.  With repro_epi::finish_elementwise instead (one thread per
//     output, reading its 2C codes one by one) the whole call took 0.130
//     against 0.057 ms at 4 x 11008 x 2048, where 172 arrays meet only
//     8192 outputs, and 0.063 against 0.051 ms at 4 x 2048 x 11008 (H100
//     80GB HBM3, 700 W, tools/time_kernel.py --kernel k7).  Chip terms take
//     repro_epi::finish_rows, which needs each row's maximum first.
//   * When K is not a multiple of array_size, one array straddles the
//     halves (its ports are the top's last rows and the bottom's first);
//     then one warp streams all K rows of its tile, parks that array's
//     first piece in float64 scratch and adds it back at the top's end.
//     Array ends inside a 4-row step split it into masked passes.
//
// K6 (the analog prefill matmul, M = 64 at serving).  What bounds it on
// this card: the float64 products, M x 2K x N multiply-adds (5.77 GFLOP at
// 64 x 4096 x 11008, 86 us at the 67 TFLOP/s of the float64 tensor cores),
// well above the bytes of the two weight halves (27 us).  The exactness
// argument above leaves no cheaper unit: a float32 sum inside an array
// would move ADC decisions.  What the design does:
//   * Float64 mma as in K7, with the roles turned and k = 8 (m16n8k8, a
//     Hopper shape): A = x (M = 64 fills four 16-row tiles), B = the plane
//     (8 rows x 8 columns), so a warp's 4 x 4 tiles of 16 x 8 outputs take
//     16 mma per step of 8 plane rows from 16 float64 loads of x and two
//     8-byte loads of 4 weights.
//   * A block of 4 warps takes 128 columns and 64 rows and streams the
//     plane rows of its arrays through a ring of 3 stages of 32 rows (16-byte
//     cp.async, swizzled as in K7, one block barrier a stage).  x is widened
//     to float64 once per call (a pass of 2 M K elements), so its stage
//     feeds the mma as copied.  Measured at 64 x 2048 x 11008 (H100 80GB
//     HBM3, 700 W, tools/time_kernel.py --kernel k6, in turns): the
//     contraction took 0.227 ms with x converted in the block each stage
//     (16-row stages, two barriers), 0.195 with x widened once, 0.184 with
//     32-row stages, 0.178 with m16n8k8 in place of m16n8k4.
//   * Blocks along z take disjoint whole arrays, as many per block as fill
//     whole waves of the card; a block stores each finished array's ADC
//     level as a byte code (wider above 8 ADC bits), [C][M][N], and a
//     finishing pass (sum_levels) adds each output's levels in array order:
//     three launches a call (two where 16-byte copies do not fit the
//     shapes), no memset.  The codes of a call are bounded, whatever M: a
//     call runs in passes over rows of x (multiples of 64) and over arrays
//     that hold at most CODE_BYTES of codes each (one pass at every serving
//     shape at M = 64); a later array pass adds its levels onto the float32
//     sums of the earlier ones, the same additions in the same order, so the
//     result does not depend on the passes.  Plane rows are found by row, so an
//     array may straddle the two halves; array ends inside a step of 8
//     rows split it into masked passes.
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

// The rounded ADC level of a partial sum, clamped to the range first.
__device__ __forceinline__ float adc_level(float psum, Adc a) {
  const float c = fminf(fmaxf(psum, 0.0f), a.range);
  return rintf(__fmul_rn(__fdiv_rn(c, a.range), a.levels));  // half to even, as jnp.round
}

// The value of level t.
__device__ __forceinline__ float adc_value(float t, Adc a) {
  return fminf(__fmul_rn(__fdiv_rn(t, a.levels), a.range), a.range);
}

// repro/kernels/analog_matmul.py::_adc_quantize, one rounding per op.
__device__ __forceinline__ float adc_quantize(float psum, Adc a) {
  return adc_value(adc_level(psum, a), a);
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

namespace k7 {
constexpr int BM = 4;             // activation rows of a tile (the decode slots)
constexpr int BN = 64;            // columns of a warp's tile
constexpr int R = 16;             // plane rows per pipeline stage
constexpr int STAGES = 4;         // depth of each warp's ring
constexpr int WARPS = 4;          // warps per block: adjacent column tiles, the same rows
constexpr int BLOCKS_PER_SM = 3;  // 3 x 74 KB of shared memory (bf16)
}  // namespace k7

// One call's scratch, carved from one buffer: the ADC codes [2][C][M][N]
// and, when K % A != 0, the straddling array's first piece [2][M][N] in
// float64.
struct Scratch {
  size_t part, total;
};

__host__ __device__ __forceinline__ size_t up16(size_t b) { return (b + 15) & ~(size_t)15; }

template <typename Code>
__host__ __device__ __forceinline__ Scratch scratch_layout(int M, int N, int K, int A) {
  const size_t C = (2 * (size_t)K + A - 1) / A;
  Scratch s;
  s.part = up16(2 * C * M * N * sizeof(Code));
  s.total = s.part + (K % A ? 2 * (size_t)M * N * sizeof(double) : 0);
  return s;
}

// One warp's shared memory: a ring of stages of both weight halves and of
// x at the ports r and r + K, and the current stage's x as float64, laid
// out as the B operand of the mma: column g < 4 is x[m0 + g, r], column
// 4 + m is x[m0 + m, r + K].
template <typename T>
struct alignas(16) Ring {
  T w[k7::STAGES][2][k7::R][k7::BN];  // [slot][wp, wn][row][16-byte chunks, swizzled]
  T x[k7::STAGES][2][k7::BM][k7::R];  // [slot][port r, port r + K][m][row]
  double xd[k7::R][2 * k7::BM];       // [row][B operand column]
};

// Position of 16-byte chunk c in stage row rr: the four rows of an mma
// step read their chunks from distinct banks.
__device__ __forceinline__ int swz(int c, int rr) { return c ^ ((rr & 3) << 1); }

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

// d += a b over one 16 x 8 x 4 float64 tile: a = (a0, a1) holds A rows g
// and g + 8 at k = t, b holds B row t, column g, d holds C rows g and g + 8
// at columns 2 t and 2 t + 1 (g = lane / 4, t = lane % 4).  Each product
// and sum is exact here (see the note at the top).
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

__device__ __forceinline__ double to_f64(float v) { return (double)v; }
__device__ __forceinline__ double to_f64(__nv_bfloat16 v) {
  return (double)__bfloat162float(v);
}

// Columns 4 g .. 4 g + 3 (w[0..3]) and 32 + 4 g .. 32 + 4 g + 3 (w[4..7])
// of stage row rr, as float64.
__device__ __forceinline__ void load8(const __nv_bfloat16* row, int g, int rr, double (&w)[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint2 v =
        *reinterpret_cast<const uint2*>(row + swz(4 * h + g / 2, rr) * 8 + (g % 2) * 4);
    w[4 * h + 0] = (double)__uint_as_float(v.x << 16);
    w[4 * h + 1] = (double)__uint_as_float(v.x & 0xffff0000u);
    w[4 * h + 2] = (double)__uint_as_float(v.y << 16);
    w[4 * h + 3] = (double)__uint_as_float(v.y & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* row, int g, int rr, double (&w)[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 v = *reinterpret_cast<const float4*>(row + swz(8 * h + g, rr) * 4);
    w[4 * h + 0] = v.x, w[4 * h + 1] = v.y, w[4 * h + 2] = v.z, w[4 * h + 3] = v.w;
  }
}

// Rows [s0, s0 + R) of the warp's range [.., r1) into ring slot `slot`:
// with VEC, 16-byte cp.async copies (zero-filled past the range, past M and
// past N); without (N, K or a pointer not 16-byte aligned), element loads.
template <typename T, bool VEC>
__device__ __forceinline__ void load_stage(Ring<T>& ring, int slot, const T* __restrict__ x,
                                           const T* __restrict__ wp, const T* __restrict__ wn,
                                           int s0, int r1, int m0, int n0, int M, int N, int K,
                                           int lane) {
  using namespace k7;
  constexpr int CE = 16 / sizeof(T);  // elements per copy
  if constexpr (VEC) {
    constexpr int RC = BN / CE;  // copies per plane row
#pragma unroll
    for (int i = lane; i < 2 * R * RC; i += 32) {
      const int pl = i / (R * RC), rr = (i / RC) % R, j = i % RC;
      const int r = s0 + rr, n = n0 + j * CE;
      const bool ok = r < r1 && n < N;
      const T* src = (pl ? wn : wp) + (ok ? (size_t)r * N + n : 0);
      cp_async16(&ring.w[slot][pl][rr][swz(j, rr) * CE], src, ok ? 16 : 0);
    }
    constexpr int XC = R / CE;  // copies per (port half, m)
    static_assert(2 * BM * XC <= 32, "one x copy per lane");
    if (lane < 2 * BM * XC) {
      const int h = lane / (BM * XC), m = (lane / XC) % BM, c = lane % XC;
      const int r = s0 + c * CE;
      const int valid = m0 + m < M ? max(0, min(CE, r1 - r)) : 0;
      const T* src = x + (valid ? (size_t)(m0 + m) * 2 * K + (size_t)h * K + r : 0);
      cp_async16(&ring.x[slot][h][m][c * CE], src, valid * (int)sizeof(T));
    }
  } else {
    for (int i = lane; i < 2 * R * BN; i += 32) {
      const int pl = i / (R * BN), rr = (i / BN) % R, j = i % BN;
      const int r = s0 + rr, n = n0 + j;
      ring.w[slot][pl][rr][swz(j / CE, rr) * CE + j % CE] =
          r < r1 && n < N ? (pl ? wn : wp)[(size_t)r * N + n] : T(0.0f);
    }
    for (int i = lane; i < 2 * BM * R; i += 32) {
      const int h = i / (BM * R), m = (i / R) % BM, rr = i % R;
      const int r = s0 + rr;
      ring.x[slot][h][m][rr] =
          r < r1 && m0 + m < M ? x[(size_t)(m0 + m) * 2 * K + (size_t)h * K + r] : T(0.0f);
    }
  }
}

// Store the ADC codes of the finished array c of polarity pol from the
// lane's accumulators to q [2][C][M][N], then zero them: acc[q][2 h + e]
// is row m0 + ((2 t + e) & 3), column n + 32 h + q (n = n0 + 4 g), so each
// (h, e) is four adjacent codes, one 4-byte store where the row allows.
template <typename Code>
__device__ __forceinline__ void flush(Code* __restrict__ q, double (&acc)[4][4], int pol, int c,
                                      int C, int m0, int t, int n, int M, int N, Adc adc) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int m = m0 + ((2 * t + e) & 3);
    Code* row = q + (((size_t)pol * C + c) * M + m) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n + 32 * h;
      uint32_t word = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t v = (uint32_t)adc_level(__double2float_rn(acc[j][2 * h + e]), adc);
        acc[j][2 * h + e] = 0.0;
        if (sizeof(Code) == 1)
          word |= v << (8 * j);
        else if (m < M && col + j < N)
          row[col + j] = (Code)v;
      }
      if (sizeof(Code) == 1 && m < M) {
        if (N % 4 == 0 && col + 4 <= N)
          *reinterpret_cast<uint32_t*>(row + col) = word;
        else
          for (int j = 0; j < 4 && col + j < N; ++j) row[col + j] = (Code)(word >> (8 * j));
      }
    }
  }
}

// The straddling array's first piece (bottom lanes, pol 0 from acc_n and
// pol 1 from acc_p) parked in part [2][M][N], or added back (top lanes).
__device__ __forceinline__ void park(double* __restrict__ part, double (&accp)[4][4],
                                     double (&accn)[4][4], bool add, int m0, int t, int n, int M,
                                     int N) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int m = m0 + ((2 * t + e) & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n + 32 * h + j;
        double& p = accp[j][2 * h + e];
        double& v = accn[j][2 * h + e];
        if (m < M && col < N) {
          double* pos = part + (size_t)m * N + col;
          double* neg = part + ((size_t)M + m) * N + col;
          if (add) {
            p += *pos;  // exact: both pieces are multiples of 2^-30
            v += *neg;
          } else {
            *pos = v;  // w_pos[r + K] = wn[r]
            *neg = p;
          }
        }
        if (!add) p = v = 0.0;
      }
  }
}

// Block (x, y, z): warp w takes the 64-column tile 4 x + w, x rows
// [4 y, 4 y + 4), and plane rows [r0, r1) of units [z upw, z upw + upw),
// a unit being one array's rows of each half (all K rows when K is not a
// multiple of A).  Each step of 4 rows r..r+3 is 8 mma, for each plane (wp,
// wn) and group q of 16 columns: A = the plane's rows at columns
// 4 i + q (A row i < 8) and 32 + 4 (i - 8) + q, B = x at ports r..r+3
// (B columns 0-3, rows m0..m0+3) and r+K..r+K+3 (columns 4-7).  Against
// wp, C columns 0-3 sum the positive polarity of the top array and 4-7 the
// negative polarity of the bottom one; against wn the other two.  An array
// boundary inside a step (K or A not a multiple of 4) splits it into
// masked passes.
template <typename T, typename Code, bool VEC>
__global__ void __launch_bounds__(k7::WARPS * 32, k7::BLOCKS_PER_SM)
    fused_contract(const T* __restrict__ x, const T* __restrict__ wp, const T* __restrict__ wn,
                   unsigned char* __restrict__ scratch, int M, int N, int K, int A, int upw,
                   Adc adc) {
  using namespace k7;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3, g = lane >> 2;  // see dmma
  const bool xtop = g < BM;  // the lane's B column: x at ports r (else r + K)
  const bool top = t < 2;    // the lane's C columns: sums of the top array (else bottom)
  Ring<T>& ring = reinterpret_cast<Ring<T>*>(smem)[warp];
  const Scratch sc = scratch_layout<Code>(M, N, K, A);
  Code* q = reinterpret_cast<Code*>(scratch);
  double* part = reinterpret_cast<double*>(scratch + sc.part);

  const int n0 = (blockIdx.x * WARPS + warp) * BN;
  if (n0 >= N) return;  // no block barrier below: an idle warp may leave
  const int unit_rows = K % A == 0 ? A : K;
  const int U = K / unit_rows;
  const int z = blockIdx.z;
  const int r0 = z * upw * unit_rows, r1 = min(U, (z + 1) * upw) * unit_rows;
  const int m0 = blockIdx.y * BM;
  const int C = (2 * K + A - 1) / A;
  // K not a multiple of A: array K / A holds the top's last rows and the
  // bottom's first rows, and this warp streams all K rows
  const bool straddle = K % A != 0;
  const int n = n0 + 4 * g;  // the lane's first accumulator column

  const int n_st = (r1 - r0 + R - 1) / R;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_st) load_stage<T, VEC>(ring, s, x, wp, wn, r0 + s * R, r1, m0, n0, M, N, K, lane);
    cp_async_commit();
  }

  double accp[4][4], accn[4][4];  // against wp and wn, column group q
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) accp[j][i] = accn[j][i] = 0.0;
  // the row after the last row of the current top and bottom array
  int top_end = min(K, (r0 / A + 1) * A);
  int bot_end = min(K, ((r0 + K) / A + 1) * A - K);

  for (int st = 0; st < n_st; ++st) {
    const int slot = st % STAGES;
    cp_async_wait<STAGES - 2>();
    __syncwarp();
    for (int i = lane; i < 2 * BM * R; i += 32) {
      const int h = i / (BM * R), mm = (i / R) % BM, rr = i % R;
      ring.xd[rr][h * BM + mm] = to_f64(ring.x[slot][h][mm][rr]);
    }
    __syncwarp();
    // refill the slot every lane finished with in the previous stage
    const int nx = st + STAGES - 1;
    if (nx < n_st)
      load_stage<T, VEC>(ring, nx % STAGES, x, wp, wn, r0 + nx * R, r1, m0, n0, M, N, K, lane);
    cp_async_commit();

    const int s0 = r0 + st * R;
    const int rows = min(R, r1 - s0);
    for (int rr = 0; rr < rows; rr += 4) {
      const int r = s0 + rr;
      double wpv[8], wnv[8];
      load8(ring.w[slot][0][rr + t], g, rr + t, wpv);
      load8(ring.w[slot][1][rr + t], g, rr + t, wnv);
      const double b = ring.xd[rr + t][g];
      const int end4 = min(4, r1 - r);
      int lo_t = 0, lo_b = 0;
      while (lo_t < end4 || lo_b < end4) {  // once, unless an array ends inside the step
        const int hi_t = min(end4, top_end - r), hi_b = min(end4, bot_end - r);
        const bool keep = xtop ? t >= lo_t && t < hi_t : t >= lo_b && t < hi_b;
        const double bm = keep ? b : 0.0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dmma(accp[j], wpv[j], wpv[4 + j], bm);
          dmma(accn[j], wnv[j], wnv[4 + j], bm);
        }
        const bool done_b = hi_b > lo_b && r + hi_b == bot_end;
        const bool done_t = hi_t > lo_t && r + hi_t == top_end;
        lo_t = hi_t;
        lo_b = hi_b;
        if (done_b || done_t) {
          const int cb = (r + hi_b - 1 + K) / A;  // ends with port r + hi_b - 1 + K
          const int ct = (r + hi_t - 1) / A;      // ends with port r + hi_t - 1
          // K % A != 0: array K / A is the bottom's first and the top's last
          const bool parked = done_b && straddle && cb == K / A;
          if (parked && !top) park(part, accp, accn, false, m0, t, n, M, N);
          if (done_t && straddle && r + hi_t == K) {
            __syncwarp();  // the parked piece, written by lane + 2
            if (top) park(part, accp, accn, true, m0, t, n, M, N);
          }
          // top lanes store the top array, bottom lanes the bottom one: one
          // pass of the whole warp where both end together
          if (top ? done_t : done_b && !parked) {
            const int c = top ? ct : cb;
            flush(q, accp, top ? 0 : 1, c, C, m0, t, n, M, N, adc);  // wp: w_pos[r], w_neg[r + K]
            flush(q, accn, top ? 1 : 0, c, C, m0, t, n, M, N, adc);  // wn: w_neg[r], w_pos[r + K]
          }
          if (done_b) bot_end = min(K, (cb + 2) * A - K);
          if (done_t) top_end = min(K, (ct + 2) * A);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// Units per warp (a block's z slice) and the grid for a shape: the number
// of units per warp that keeps the most block slots of the card busy over
// whole waves, the larger on a tie.
struct FusedPlan {
  int upw, gx, gy, gz;
};

FusedPlan fused_plan(int M, int N, int K, int A) {
  using namespace k7;
  FusedPlan p;
  const int U = K % A == 0 ? K / A : 1;
  p.gx = ((N + BN - 1) / BN + WARPS - 1) / WARPS;
  p.gy = (M + BM - 1) / BM;
  const long long slots = (long long)repro_epi::sm_count() * BLOCKS_PER_SM;
  double best = -1.0;
  for (int upw = U; upw >= 1; --upw) {
    const int gz = (U + upw - 1) / upw;
    const long long waves = ((long long)p.gx * p.gy * gz + slots - 1) / slots;
    const double use = (double)p.gx * p.gy * U / ((double)waves * slots * upw);
    if (use > best + 1e-9) {
      best = use;
      p.upw = upw;
      p.gz = gz;
    }
  }
  return p;
}

template <typename T, typename Code, bool VEC>
void launch_fused(const T* x, const T* wp, const T* wn, unsigned char* scratch, int M, int N,
                  int K, int A, Adc adc, cudaStream_t st) {
  const FusedPlan p = fused_plan(M, N, K, A);
  const int smem = k7::WARPS * (int)sizeof(Ring<T>);
  static bool attr = [smem] {
    cudaFuncSetAttribute(fused_contract<T, Code, VEC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(fused_contract<T, Code, VEC>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    return true;
  }();
  (void)attr;
  fused_contract<T, Code, VEC><<<dim3(p.gx, p.gy, p.gz), k7::WARPS * 32, smem, st>>>(
      x, wp, wn, scratch, M, N, K, A, p.upw, adc);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T, typename Code>
void run_fused(const void* x, const void* wp, const void* wn, unsigned char* scratch, int M,
               int N, int K, int A, Adc adc, cudaStream_t st) {
  constexpr int CE = 16 / sizeof(T);
  // 16-byte copies need 16-byte rows, stage starts and pointers
  const bool vec = N % CE == 0 && K % CE == 0 && (K % A != 0 || A % CE == 0) &&
                   aligned16(x) && aligned16(wp) && aligned16(wn);
  const T* xt = static_cast<const T*>(x);
  const T* a = static_cast<const T*>(wp);
  const T* b = static_cast<const T*>(wn);
  if (vec)
    launch_fused<T, Code, true>(xt, a, b, scratch, M, N, K, A, adc, st);
  else
    launch_fused<T, Code, false>(xt, a, b, scratch, M, N, K, A, adc, st);
}

// K7's finishing pass without chip terms: a block takes 128 outputs,
// stages their ADC codes in shared memory a chunk of arrays at a time
// (16-byte loads, one row of 128 codes per array and polarity), and each
// thread adds its output's levels in array order per polarity, subtracts,
// rescales, casts and applies the correction polynomial.
template <typename T, typename Code>
__global__ void __launch_bounds__(128)
    finish_sums(const Code* __restrict__ q, Adc adc, const float* __restrict__ pre,
                const float* __restrict__ coeffs, int P, T* __restrict__ out,
                int M, int N, int C) {
  constexpr int TB = 128, CC = 64 / sizeof(Code);  // outputs, arrays per chunk
  __shared__ __align__(16) Code codes[2][CC][TB];
  __shared__ float level[256];  // the value of each level (uint8 codes)
  const size_t MN = (size_t)M * N, i0 = (size_t)blockIdx.x * TB;
  const int tid = threadIdx.x;
  constexpr bool table = sizeof(Code) == 1;
  if (table)
    for (int v = tid; v <= (int)adc.levels; v += TB) level[v] = adc_value((float)v, adc);
  const bool vec = table && MN % 16 == 0 && i0 + TB <= MN;
  float sp = 0.0f, sn = 0.0f;
  for (int c0 = 0; c0 < C; c0 += CC) {
    const int cc = min(CC, C - c0);
    __syncthreads();  // the previous chunk is consumed
    if (vec) {
      for (int k = tid; k < 2 * cc * (TB / 16); k += TB) {
        const int r = k / (TB / 16), u = k % (TB / 16), pol = r / cc, c = r % cc;
        reinterpret_cast<uint4*>(codes[pol][c])[u] =
            reinterpret_cast<const uint4*>(q + ((size_t)pol * C + c0 + c) * MN + i0)[u];
      }
    } else {
      for (int k = tid; k < 2 * cc * TB; k += TB) {
        const int r = k / TB, o = k % TB, pol = r / cc, c = r % cc;
        codes[pol][c][o] = i0 + o < MN ? q[((size_t)pol * C + c0 + c) * MN + i0 + o] : Code(0);
      }
    }
    __syncthreads();
    for (int c = 0; c < cc; ++c) {
      const Code a = codes[0][c][tid], b = codes[1][c][tid];
      sp = __fadd_rn(sp, table ? level[a] : adc_value((float)a, adc));
      sn = __fadd_rn(sn, table ? level[b] : adc_value((float)b, adc));
    }
  }
  const size_t i = i0 + tid;
  if (i < MN) {
    float y = repro_epi::rnd<T>(__fmul_rn(__fsub_rn(sp, sn), pre[i / N]));
    if (P > 0) y = repro_epi::correct<T>(y, coeffs, P);
    repro_epi::store<T>(out, i, y);
  }
}

// The same value for the finishing pass with chip terms
// (repro_epi::finish_rows, which needs each row's maximum first): each
// polarity's ADC levels added in array order, then (sum_p - sum_n) * pre[m].
template <typename T, typename Code>
struct ArraySums {
  const Code* q;  // [2][C][M][N] ADC codes
  const float* pre;
  size_t MN;
  int C;
  Adc adc;
  __device__ float operator()(size_t i, int m) const {
    float sp = 0.0f, sn = 0.0f;
    for (int c = 0; c < C; ++c) {
      sp = __fadd_rn(sp, adc_value((float)q[(size_t)c * MN + i], adc));
      sn = __fadd_rn(sn, adc_value((float)q[(size_t)(C + c) * MN + i], adc));
    }
    return repro_epi::rnd<T>(__fmul_rn(__fsub_rn(sp, sn), pre[m]));
  }
};

template <typename T, typename Code>
void finish_fused(const Code* q, const float* pre, const void* gain, const void* add,
                  const float* coeffs, int P, float eps, void* out, int M,
                  int N, int C, Adc adc, cudaStream_t st) {
  const size_t MN = (size_t)M * N;
  if (add == nullptr)
    finish_sums<T, Code><<<(unsigned)((MN + 127) / 128), 128, 0, st>>>(
        q, adc, pre, coeffs, P, static_cast<T*>(out), M, N, C);
  else
    repro_epi::finish<T>(ArraySums<T, Code>{q, pre, MN, C, adc}, gain, add, coeffs, P,
                         eps, out, M, N, st);
}

template <typename Code>
void fused(int in_bf16, int out_bf16, const void* x, const void* wp, const void* wn,
           unsigned char* scratch, const float* pre, const void* gain, const void* add,
           const float* coeffs, int P, float eps, void* out, int M, int N,
           int K, int A, Adc adc, cudaStream_t st) {
  if (in_bf16)
    run_fused<__nv_bfloat16, Code>(x, wp, wn, scratch, M, N, K, A, adc, st);
  else
    run_fused<float, Code>(x, wp, wn, scratch, M, N, K, A, adc, st);
  const Code* q = reinterpret_cast<const Code*>(scratch);
  const int C = (2 * K + A - 1) / A;
  if (out_bf16)
    finish_fused<__nv_bfloat16, Code>(q, pre, gain, add, coeffs, P, eps, out, M, N,
                                      C, adc, st);
  else
    finish_fused<float, Code>(q, pre, gain, add, coeffs, P, eps, out, M, N, C, adc,
                              st);
}

Adc make_adc(int adc_bits, float adc_range) {
  return Adc{adc_range, (float)((1 << adc_bits) - 1)};
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

namespace k6 {
constexpr int BM = 64;          // activation rows of a block: four 16-row mma tiles
constexpr int BN = 128;         // columns of a block
constexpr int WARPS = 4;        // warps of a block, adjacent 32-column tiles
constexpr int WN = BN / WARPS;  // columns of a warp: four 8-column mma tiles
constexpr int R = 32;           // plane rows per pipeline stage
constexpr int STAGES = 3;       // depth of the block's ring
constexpr int NT = WARPS * 32;  // threads of a block
constexpr int XS = R + 4;       // row stride of a stage's float64 x: A loads without conflicts
constexpr int BLOCKS_PER_SM = 2;
// Bytes of ADC codes that one pass may hold: a call runs the rows and arrays
// in passes of at most this many bytes of codes, so its scratch does not
// grow with M (and stays below 2^31 at any M).
constexpr size_t CODE_BYTES = size_t(1) << 29;
static_assert(WN == 32, "a lane's B operand is 4 adjacent columns of its warp's 32");
}  // namespace k6

// d += a b over one 16 x 8 x 8 float64 tile: a0, a1 hold A rows g and
// g + 8 at k = t, a2, a3 the same rows at k = t + 4; b0, b1 hold B rows t
// and t + 4 at column g; d as in dmma.
__device__ __forceinline__ void dmma8(double (&d)[4], double a0, double a1, double a2,
                                      double a3, double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// One stage of the block's ring: plane rows s0 .. s0 + R - 1 for the
// block's columns (16-byte chunks swizzled as in K7), and x at those ports
// as float64 (widened once per call, so the stage feeds the mma as it is).
template <typename T>
struct alignas(16) Stage6 {
  T w[k6::R][k6::BN];          // [row][column of the block]
  double x[k6::BM][k6::XS];    // [activation row][port], padded rows
};

template <typename T>
constexpr int k6_smem() {
  return k6::STAGES * (int)sizeof(Stage6<T>);
}

// x64[i] = x[i] as float64: the activations widened once per call (M x 2K).
template <typename T>
__global__ void widen(const T* __restrict__ x, double* __restrict__ x64, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    x64[i] = to_f64(x[i]);
}

// Plane rows [s0, s0 + R) of the block's range [.., r1) into a stage, every
// thread taking its share: with VEC, 16-byte cp.async copies (zero-filled
// past the range, past M and past N; x from its float64 copy x64); without,
// element loads (x from x itself).  Row gk of the plane is wa's row gk for
// gk < K, else wb's row gk - K.
template <typename T, bool VEC>
__device__ __forceinline__ void load_stage6(Stage6<T>& sg, const T* __restrict__ x,
                                            const double* __restrict__ x64,
                                            const T* __restrict__ wa, const T* __restrict__ wb,
                                            int s0, int r1, int m0, int n0, int M, int N, int K,
                                            int tid) {
  using namespace k6;
  constexpr int CE = 16 / sizeof(T);  // elements per copy
  const size_t P = 2 * (size_t)K;
  if constexpr (VEC) {
    constexpr int RC = BN / CE;  // copies per plane row
    for (int i = tid; i < R * RC; i += NT) {
      const int rr = i / RC, j = i % RC;
      const int gk = s0 + rr, n = n0 + j * CE;
      const bool ok = gk < r1 && n < N;
      const T* src = ok ? (gk < K ? wa + (size_t)gk * N : wb + (size_t)(gk - K) * N) + n : wa;
      cp_async16(&sg.w[rr][swz(j, rr) * CE], src, ok ? 16 : 0);
    }
    constexpr int XC = R / 2;  // copies per activation row, 2 doubles each
    for (int i = tid; i < BM * XC; i += NT) {
      const int m = i / XC, c = i % XC;
      const int gk = s0 + 2 * c;
      const int valid = m0 + m < M ? max(0, min(2, r1 - gk)) : 0;
      const double* src = valid ? x64 + (size_t)(m0 + m) * P + gk : x64;
      cp_async16(&sg.x[m][2 * c], src, valid * (int)sizeof(double));
    }
  } else {
    for (int i = tid; i < R * BN; i += NT) {
      const int rr = i / BN, j = i % BN;
      const int gk = s0 + rr, n = n0 + j;
      sg.w[rr][swz(j / CE, rr) * CE + j % CE] =
          gk < r1 && n < N ? (gk < K ? wa[(size_t)gk * N + n] : wb[(size_t)(gk - K) * N + n])
                           : T(0.0f);
    }
    for (int i = tid; i < BM * R; i += NT) {
      const int m = i / R, rr = i % R;
      sg.x[m][rr] = s0 + rr < r1 && m0 + m < M ? to_f64(x[(size_t)(m0 + m) * P + s0 + rr]) : 0.0;
    }
  }
}

// The lane's B operand of the four column tiles: columns col .. col + 3 of
// the block in stage row rr, as float64.
__device__ __forceinline__ void load_b(const __nv_bfloat16* row, int col, int rr, double (&b)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(row + swz(col / 8, rr) * 8 + col % 8);
  b[0] = (double)__uint_as_float(v.x << 16);
  b[1] = (double)__uint_as_float(v.x & 0xffff0000u);
  b[2] = (double)__uint_as_float(v.y << 16);
  b[3] = (double)__uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void load_b(const float* row, int col, int rr, double (&b)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(row + swz(col / 4, rr) * 4);
  b[0] = v.x, b[1] = v.y, b[2] = v.z, b[3] = v.w;
}

// The ADC codes of the finished array c from the lane's accumulators to
// q [C][M][N], then zero them.  acc[i][j] holds rows m0 + 16 i + g and
// m0 + 16 i + g + 8 at columns n + j and n + 4 + j (n: the lane's first
// column), so a lane stores 8 adjacent codes per row: one 8-byte store
// where the row allows.
template <typename Code>
__device__ __forceinline__ void flush6(Code* __restrict__ q, double (&acc)[4][4][4], int c,
                                       int m0, int g, int n, int M, int N, Adc adc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 16 * i + g + 8 * e;
      uint32_t v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = (uint32_t)adc_level(__double2float_rn(acc[i][j][2 * e]), adc);
        v[4 + j] = (uint32_t)adc_level(__double2float_rn(acc[i][j][2 * e + 1]), adc);
        acc[i][j][2 * e] = acc[i][j][2 * e + 1] = 0.0;
      }
      if (m >= M) continue;
      Code* row = q + ((size_t)c * M + m) * N;
      if (sizeof(Code) == 1 && N % 8 == 0 && n + 8 <= N) {
        *reinterpret_cast<uint2*>(row + n) =
            make_uint2(v[0] | v[1] << 8 | v[2] << 16 | v[3] << 24,
                       v[4] | v[5] << 8 | v[6] << 16 | v[7] << 24);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (n + k < N) row[n + k] = (Code)v[k];
      }
    }
}

// Block (x, y, z): columns [128 x, 128 x + 128), activation rows
// [64 y, 64 y + 64) and the whole arrays [cf + z apb, cf + z apb + apb) of
// the pass's arrays [cf, cf + cn) of the 2K ports, streamed R rows a stage
// through the block's ring; array c's codes go to q's slot c - cf.  Warp v takes
// columns 32 v .. 32 v + 31.  A step of 8 plane rows r .. r + 7 is 16 mma:
// A = x at rows 16 i .. 16 i + 15, ports r .. r + 7 (i < 4), B = the plane's
// rows r .. r + 7 at columns 4 g + j of the warp's (g the B column, j < 4).
// An array that ends inside a step splits it into masked passes.
template <typename T, typename Code, bool VEC>
__global__ void __launch_bounds__(k6::NT, k6::BLOCKS_PER_SM)
    prefill_contract(const T* __restrict__ x, const double* __restrict__ x64,
                     const T* __restrict__ wa, const T* __restrict__ wb, Code* __restrict__ q,
                     int M, int N, int K, int A, int cf, int cn, int apb, Adc adc) {
  using namespace k6;
  extern __shared__ __align__(16) unsigned char smem[];
  Stage6<T>* ring = reinterpret_cast<Stage6<T>*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3, g = lane >> 2;  // see dmma
  const int P = 2 * K;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int c0 = cf + blockIdx.z * apb;
  const int r0 = c0 * A, r1 = min(P, min(c0 + apb, cf + cn) * A);
  const int n_st = (r1 - r0 + R - 1) / R;
  const int col = warp * WN + 4 * g;     // the lane's B columns in the block
  const int n = n0 + warp * WN + 8 * t;  // the lane's first accumulator column

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_st)
      load_stage6<T, VEC>(ring[s], x, x64, wa, wb, r0 + s * R, r1, m0, n0, M, N, K, tid);
    cp_async_commit();
  }

  double acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.0;
  int c = c0;                         // the current array
  int c_end = min(r1, (c0 + 1) * A);  // the row after its last

  for (int st = 0; st < n_st; ++st) {
    const int slot = st % STAGES;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage st has landed; every warp is done with stage st - 1
    const int nx = st + STAGES - 1;
    if (nx < n_st)
      load_stage6<T, VEC>(ring[nx % STAGES], x, x64, wa, wb, r0 + nx * R, r1, m0, n0, M, N, K,
                          tid);
    cp_async_commit();

    const int s0 = r0 + st * R;
    const int rows = min(R, r1 - s0);
    for (int rr = 0; rr < rows; rr += 8) {
      const int r = s0 + rr;
      double b0[4], b1[4];
      load_b(ring[slot].w[rr + t], col, rr + t, b0);
      load_b(ring[slot].w[rr + t + 4], col, rr + t + 4, b1);
      const double* xr = &ring[slot].x[g][rr + t];
      const int end8 = min(8, r1 - r);
      if (end8 == 8 && c_end - r >= 8) {  // the current array takes the whole step
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const double a0 = xr[16 * i * XS], a1 = xr[(16 * i + 8) * XS];
          const double a2 = xr[16 * i * XS + 4], a3 = xr[(16 * i + 8) * XS + 4];
#pragma unroll
          for (int j = 0; j < 4; ++j) dmma8(acc[i][j], a0, a1, a2, a3, b0[j], b1[j]);
        }
        if (c_end == r + 8) {
          flush6(q, acc, c - cf, m0, g, n, M, N, adc);
          ++c;
          c_end = min(r1, c_end + A);
        }
        continue;
      }
      int lo = 0;
      while (lo < end8) {  // passes split at array ends
        const int hi = min(end8, c_end - r);
        const bool k0 = t >= lo && t < hi, k1 = t + 4 >= lo && t + 4 < hi;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const double a0 = k0 ? xr[16 * i * XS] : 0.0, a1 = k0 ? xr[(16 * i + 8) * XS] : 0.0;
          const double a2 = k1 ? xr[16 * i * XS + 4] : 0.0;
          const double a3 = k1 ? xr[(16 * i + 8) * XS + 4] : 0.0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dmma8(acc[i][j], a0, a1, a2, a3, k0 ? b0[j] : 0.0, k1 ? b1[j] : 0.0);
        }
        if (r + hi == c_end) {
          flush6(q, acc, c - cf, m0, g, n, M, N, adc);
          ++c;
          c_end = min(r1, c_end + A);
        }
        lo = hi;
      }
    }
  }
  cp_async_wait<0>();
}

// K6's finishing pass: a block takes 128 outputs, stages their ADC codes in
// shared memory a chunk of arrays at a time (16-byte loads), and each
// thread adds its output's levels in array order, onto the sum of the
// earlier arrays' pass when carry is set (the same float32 additions in
// the same order as one pass over all arrays).
template <typename Code>
__global__ void __launch_bounds__(128)
    sum_levels(const Code* __restrict__ q, Adc adc, float* __restrict__ out, size_t MN, int C,
               bool carry) {
  constexpr int TB = 128, CC = 64 / sizeof(Code);  // outputs, arrays per chunk
  constexpr int CPR = TB * sizeof(Code) / 16;      // 16-byte loads per array row
  __shared__ __align__(16) Code codes[CC][TB];
  __shared__ float level[256];  // the value of each level (uint8 codes)
  const size_t i0 = (size_t)blockIdx.x * TB;
  const int tid = threadIdx.x;
  constexpr bool table = sizeof(Code) == 1;
  if (table)
    for (int v = tid; v <= (int)adc.levels; v += TB) level[v] = adc_value((float)v, adc);
  const bool vec = MN % 16 == 0 && i0 + TB <= MN;
  float s = carry && i0 + tid < MN ? out[i0 + tid] : 0.0f;
  for (int a0 = 0; a0 < C; a0 += CC) {
    const int cc = min(CC, C - a0);
    __syncthreads();  // the previous chunk is consumed
    if (vec) {
      for (int k = tid; k < cc * CPR; k += TB)
        reinterpret_cast<uint4*>(codes[k / CPR])[k % CPR] =
            reinterpret_cast<const uint4*>(q + (size_t)(a0 + k / CPR) * MN + i0)[k % CPR];
    } else {
      for (int k = tid; k < cc * TB; k += TB) {
        const int r = k / TB, o = k % TB;
        codes[r][o] = i0 + o < MN ? q[(size_t)(a0 + r) * MN + i0 + o] : Code(0);
      }
    }
    __syncthreads();
    for (int r = 0; r < cc; ++r) {
      const Code v = codes[r][tid];
      s = __fadd_rn(s, table ? level[v] : adc_value((float)v, adc));
    }
  }
  if (i0 + tid < MN) out[i0 + tid] = s;
}

// Arrays per block (the grid's z) for a pass of C arrays: the number that
// keeps the most block slots of the card busy over whole waves, the larger
// on a tie.
struct PrefillPlan {
  int apb, gx, gy, gz, C;
};

PrefillPlan prefill_plan(int M, int N, int C) {
  using namespace k6;
  PrefillPlan p;
  p.C = C;
  p.gx = (N + BN - 1) / BN;
  p.gy = (M + BM - 1) / BM;
  p.apb = 1;
  p.gz = p.C;
  const long long slots = (long long)repro_epi::sm_count() * BLOCKS_PER_SM;
  double best = -1.0;
  for (int apb = p.C; apb >= 1; --apb) {
    const int gz = (p.C + apb - 1) / apb;
    const long long waves = ((long long)p.gx * p.gy * gz + slots - 1) / slots;
    const double use = (double)p.gx * p.gy * p.C / ((double)waves * slots * apb);
    if (use > best + 1e-9) {
      best = use;
      p.apb = apb;
      p.gz = gz;
    }
  }
  return p;
}

template <typename T, typename Code, bool VEC>
void launch_prefill(const T* x, const double* x64, const T* wa, const T* wb, Code* q, int M,
                    int N, int K, int A, int cf, const PrefillPlan& p, Adc adc, cudaStream_t st) {
  constexpr int smem = k6_smem<T>();
  static bool attr = [] {
    cudaFuncSetAttribute(prefill_contract<T, Code, VEC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(prefill_contract<T, Code, VEC>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    return true;
  }();
  (void)attr;
  prefill_contract<T, Code, VEC><<<dim3(p.gx, p.gy, p.gz), k6::NT, smem, st>>>(
      x, x64, wa, wb, q, M, N, K, A, cf, p.C, p.apb, adc);
}

// K6's passes at a shape: rows of x a pass (a multiple of 64 unless it is
// all of M) and arrays a pass, so that a pass's codes [arrays][rows][N]
// stay within CODE_BYTES where 64 rows of one array allow it; then the
// scratch: those codes, then (16-byte aligned) the pass's rows of x as
// float64 [rows][2K].
struct Passes {
  int rows, arrays, C;
  size_t codes, total;
};

template <typename Code>
Passes prefill_passes(int M, int N, int K, int A) {
  using namespace k6;
  using std::max;
  using std::min;
  Passes p;
  p.C = (2 * K + A - 1) / A;
  const size_t row_codes = (size_t)max(p.C, 1) * N * sizeof(Code);
  const size_t row_x = 2 * (size_t)K * sizeof(double);
  const size_t fit = CODE_BYTES / max<size_t>(row_codes + row_x, 1) / BM * BM;
  p.rows = (int)min<size_t>(M, max<size_t>(BM, fit));
  const size_t array_codes = max<size_t>((size_t)p.rows * N * sizeof(Code), 1);
  p.arrays = (int)min<size_t>(max(p.C, 1), max<size_t>(1, CODE_BYTES / array_codes));
  p.codes = up16((size_t)p.arrays * p.rows * N * sizeof(Code));
  p.total = p.codes + (size_t)p.rows * row_x;
  return p;
}

// Rows [m0, m0 + rows) of x, then arrays [cf, cf + arrays) of the plane a
// pass: widen those rows, contract, add the levels onto out (carrying the
// sum of the arrays before cf).
template <typename T, typename Code>
void prefill(const void* x, const void* wa, const void* wb, unsigned char* scratch, float* out,
             int M, int N, int K, int A, Adc adc, cudaStream_t st) {
  constexpr int CE = 16 / sizeof(T);
  const Passes ps = prefill_passes<Code>(M, N, K, A);
  if ((size_t)M * N == 0) return;
  Code* q = reinterpret_cast<Code*>(scratch);
  double* x64 = reinterpret_cast<double*>(scratch + ps.codes);
  // 16-byte copies need 16-byte rows, stage starts and pointers
  const bool vec = N % CE == 0 && (2 * K) % CE == 0 && A % CE == 0 && aligned16(x) &&
                   aligned16(wa) && aligned16(wb);
  const T* a = static_cast<const T*>(wa);
  const T* b = static_cast<const T*>(wb);
  for (int m0 = 0; m0 < M; m0 += ps.rows) {
    const int mb = min(ps.rows, M - m0);
    const T* xm = static_cast<const T*>(x) + (size_t)m0 * 2 * K;
    float* om = out + (size_t)m0 * N;
    const size_t MN = (size_t)mb * N;
    if (ps.C == 0) {
      sum_levels<Code><<<(unsigned)((MN + 127) / 128), 128, 0, st>>>(q, adc, om, MN, 0, false);
      continue;
    }
    if (vec) {
      const size_t n = 2 * (size_t)mb * K;
      widen<T><<<repro_epi::grid_for(n, 256), 256, 0, st>>>(xm, x64, n);
    }
    for (int cf = 0; cf < ps.C; cf += ps.arrays) {
      const PrefillPlan p = prefill_plan(mb, N, min(ps.arrays, ps.C - cf));
      if (vec)
        launch_prefill<T, Code, true>(xm, x64, a, b, q, mb, N, K, A, cf, p, adc, st);
      else
        launch_prefill<T, Code, false>(xm, nullptr, a, b, q, mb, N, K, A, cf, p, adc, st);
      sum_levels<Code><<<(unsigned)((MN + 127) / 128), 128, 0, st>>>(q, adc, om, MN, p.C,
                                                                      cf > 0);
    }
  }
}

template <typename Code>
void prefill_any(int in_bf16, const void* x, const void* wa, const void* wb, void* scratch,
                 float* out, int M, int N, int K, int A, Adc adc, cudaStream_t st) {
  unsigned char* s = static_cast<unsigned char*>(scratch);
  if (in_bf16)
    prefill<__nv_bfloat16, Code>(x, wa, wb, s, out, M, N, K, A, adc, st);
  else
    prefill<float, Code>(x, wa, wb, s, out, M, N, K, A, adc, st);
}

}  // namespace
}  // namespace repro_analog

using namespace repro_analog;

// Bytes of K6's scratch at this shape (see Passes): a pass's ADC codes,
// uint8 when adc_bits <= 8, else uint32, then its rows of x as float64; -1
// past 2^31 (only where 64 rows of x or of one array's codes pass it).
extern "C" int analog_scratch_bytes(int M, int N, int K, int array_size, int adc_bits) {
  const size_t n = adc_bits <= 8 ? prefill_passes<uint8_t>(M, N, K, array_size).total
                                 : prefill_passes<uint32_t>(M, N, K, array_size).total;
  return n > 0x7fffffff ? -1 : (int)n;
}

// K6: out[M,N] (float32) = sum over arrays of adc(x[m, array] . [wa; wb][array, n]),
// added in array order.  x [M, 2K], wa, wb [K, N]: float32 or bfloat16.
// q: analog_scratch_bytes(), written before it is read (no memset).  Three
// launches a pass (two when the shapes or pointers do not allow 16-byte
// copies); one pass up to CODE_BYTES of codes (all serving shapes at M = 64).
extern "C" int analog_matmul(int in_bf16, const void* x, const void* wa, const void* wb, void* q,
                             float* out, int M, int N, int K, int array_size, int adc_bits,
                             float adc_range, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Adc adc = make_adc(adc_bits, adc_range);
  if (adc_bits <= 8)
    prefill_any<uint8_t>(in_bf16, x, wa, wb, q, out, M, N, K, array_size, adc, st);
  else
    prefill_any<uint32_t>(in_bf16, x, wa, wb, q, out, M, N, K, array_size, adc, st);
  return (int)cudaGetLastError();
}

// Bytes of K7's scratch at this shape (see Scratch); -1 past 2^31.
extern "C" int analog_fused_scratch_bytes(int M, int N, int K, int array_size, int adc_bits) {
  const size_t n = adc_bits <= 8 ? scratch_layout<uint8_t>(M, N, K, array_size).total
                                 : scratch_layout<uint32_t>(M, N, K, array_size).total;
  return n > 0x7fffffff ? -1 : (int)n;
}

// K7: both polarities, w_pos = [wp; wn] and w_neg = [wn; wp], then
// ((sum_p - sum_n) * pre[m]) cast to the output type, then the epilogue as
// in K2.  scratch: analog_fused_scratch_bytes(); the ADC codes in it are
// uint8 when adc_bits <= 8, else uint32.
extern "C" int analog_matmul_fused(int in_bf16, int out_bf16, const void* x, const void* wp,
                                   const void* wn, void* scratch, const float* pre,
                                   const void* gain, const void* add, const float* coeffs, int P,
                                   float eps, void* out, int M, int N, int K,
                                   int array_size, int adc_bits, float adc_range, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Adc adc = make_adc(adc_bits, adc_range);
  unsigned char* s = static_cast<unsigned char*>(scratch);
  if (adc_bits <= 8)
    fused<uint8_t>(in_bf16, out_bf16, x, wp, wn, s, pre, gain, add, coeffs, P, eps,
                   out, M, N, K, array_size, adc, st);
  else
    fused<uint32_t>(in_bf16, out_bf16, x, wp, wn, s, pre, gain, add, coeffs, P, eps,
                    out, M, N, K, array_size, adc, st);
  return (int)cudaGetLastError();
}

extern "C" const char* analog_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
