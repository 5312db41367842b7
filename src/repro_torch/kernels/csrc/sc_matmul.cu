// Stochastic-computing contractions on Hopper CUDA cores: kernels K4 and K5.
//
// Replaces the Pallas TPU kernels repro/kernels/sc_matmul.py:
//   sc_matmul_packed        (_kernel)       -> sc_matmul_quantized() (the
//                                              prefill projection, both
//                                              polarities), sc_matmul(),
//                                              sc_matmul_words()
//   sc_matmul_packed_fused  (_fused_kernel) -> sc_matmul_fused()
// together with the stream generation that repro/kernels/ops.py runs in
// front of them (ref.sc_pack_streams: bit j of a word is p > u_j, 32 bits
// per uint32 word, least significant bit first), whose thresholds
// sc_tables() prepares once per set of draws.
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
// Threshold tables (sc_tables, one launch per set of draws).  For port k
// and word w, one row merges the 32 thresholds of sequence k and the 32 of
// sequence k + K, sorted ascending as floats, with 65 mask pairs: pair c
// holds, for each of the two sequences, the stream bits of the c smallest
// of the 64.  A probability p sets exactly the bits j with u_j < p, which
// are the c = #{u < p} smallest, so finding c gives both of its words,
// against port k and against port k + K: bitwise the same as p > u_j bit
// by bit, ties, -0.0 and NaN included (NaN thresholds sort last, and a
// comparison with NaN is false either way).  c is found without a search:
// the row also holds 256 value buckets [b / 256, (b + 1) / 256), each the
// range [start, end) of sorted positions of its thresholds; thresholds in
// lower buckets are all < p and in higher ones all > p, so c is start plus
// the thresholds of p's own bucket below p, a prefix of them (with 64
// uniform thresholds, 78% of buckets hold none and 2.6% more than one).
// Row K holds the activation sequence twice.  One warp builds a row: lane
// j finds the rank of threshold j of each sequence by comparing across the
// warp, with no local-memory arrays.  The serving path builds the tables
// of a projection once per decode step and shares them across its 36
// layers (repro_torch.core.approx_linear.ApproxCtx); a prefill projection
// builds its own.
//
// K5 (the SC decode matmul, M = 4 at serving).  What bounds it on this
// card: the bytes of the two bf16 weight halves (90 MB at 2048 x 11008,
// 27 us at 3.35 TB/s), and, above them, the instructions that build the
// streams.  Each weight pair (a, b) = (wp[k, n], wn[k, n]) needs 4 words,
// a and b against ports k and k + K; two lookups in the merged row give
// them.  A lookup is ~20 instructions (the bucket: a multiply, a
// conversion, a clamp; its entry: a load and two extracts; two predicated
// compare steps of 5; the mask pair's load); with 16 LOP3 for the OR of
// the ANDs over 4 rows and 2 polarities, 2 unpacks and the rare third
// step's test, ~63 a pair: 1.4 G at 2048 x 11008, 47 us at 132 SMs x 128
// lanes x 1.98 GHz, with 8 shared-memory loads a pair.  Measured at this
// shape on an H100 (tools/time_kernel.py; PERF.md): 0.119 ms a call; with
// a 7-step binary search over the 64 sorted thresholds instead (~6
// instructions and a load a step) 0.133 ms; with the lookups switched off
// 0.039 ms, so the lookups, not the bytes, take most of the time.
// What the design does:
//   * Each weight pair is read from device memory once per 4 activation
//     rows, by 16-byte cp.async copies into a ring of 4 stages of 4 rows
//     shared by the block's 4 warps (one barrier per stage): three stages
//     in flight while one is contracted, 2 blocks an SM.  A lane takes 8
//     adjacent columns and a warp a tile of 256; the block's warps take 4
//     adjacent tiles of the same rows (for N < 1024, fewer tiles, and the
//     warps of a tile split its rows).
//   * The stage carries the table rows of its 4 ports, so each block reads
//     the table of its k-range once for all its 1024 columns, not once per
//     16 rows per column block.
//   * The 4 words of a pair are built in registers and ANDed with the
//     activation words at once; accumulators stay in registers (8 columns
//     x 4 rows x 2 polarities a lane).  The activation words of a stage
//     are built in the block from x and the activation row of the table,
//     one per lane, and passed by shuffles: no pack_x launch.
//   * K is split across blocks to fill whole waves of the card.  At the
//     end the warps of a block combine in shared memory and the block ORs
//     its words into the accumulators with atomics.  The accumulators are
//     kept clear between calls: the finishing pass (PlaneDifference, one
//     thread per output) zeroes what it has read, so a call is two
//     launches and no memset.
//   * AND, OR and popcount are order-free, so no tiling, split or atomic
//     order can change a bit: K4 and K5 are bitwise equal to their plain
//     versions.
//
// K4 (prefill, M = 64 and more) as the serving path calls it,
// sc_matmul_quantized(): the SC prefill projection from the raw operands,
// with the value-domain code in front of the reference's pallas_call
// (repro/core/backends.py:_emulate_sc: per-tensor scales, q = rnd(g / s),
// planes clamp(max(+-rnd(v q), 0), 0, 1)) taken in.  What bounds it on this
// card: the AND bit products, 64 x 4096 x 11008 x 32 x 2 polarities at
// gate/up.  The binary tensor cores (mma.m16n8k256.b1.and.popc) run them
// at 10x the ALU pipe's LOP3 bit rate here (tools/bench_b1_mma.py,
// PERF.md section 6): 0.036 ms, above the bytes (the bf16 weights once:
// 14 us).  This kernel does them on the ALU pipe instead, one LOP3 per
// row, port pair, column, polarity and stream word, (a & b) | acc twice
// for the two ports of a pair: 0.345 ms at 132 SMs x 64 lanes x 1.98 GHz.
// The mma gives counts, not an OR, and wants the streams as bit planes
// along k; PERF.md section 6 counts the ALU work that leaves a b1
// contraction (the test count > 0 of each row, column, polarity and bit
// per k-range whose planes fit in shared memory, the transposes of the
// built words, the lookups this kernel makes too) at about 0.2-0.26 ms,
// about 2x this one.  That route is ROADMAP B2's next step.  What the
// design does:
//   * Three launches.  A scale pass reads x and w once for max |x|, max |w|
//     (integer atomicMax of |v|'s bits: order-free) and its last block
//     writes q = rnd(g / s) for both and the rescale.  The contraction
//     forms v = rnd(w q) as it builds a weight's words: one of the planes
//     at v is min(|v|, 1) and the other 0, so one lookup (row_words) gives
//     the non-zero plane's words against ports k and k + K, the zero
//     plane's being the table row's words of 0 (none unless a threshold is
//     below 0); four words a weight, both polarities.  Activations the
//     same way against the activation row.  No plain-torch op touches a
//     weight, and each weight is looked up once, where the parent's two
//     K4 calls did it four times.  The finishing pass (PrefillDifference)
//     turns the words into the value, rescales and casts, and clears them.
//   * A block takes 64 rows x 128 columns and one stream word (grid z),
//     a thread 8 rows x 4 columns x 2 polarities (64 accumulators; the
//     accumulators of more words would not fit its registers, so W > 1
//     runs one word a block: the lookups and LOP3 are per word anyway, and
//     a weight's second read comes from L2).  The block's 8 warps take 8
//     rows each; a lane the columns lane + 32 j, so its words and the
//     activation words of its rows are 16-byte shared-memory loads without
//     bank conflicts: 5 loads a row of a stage against 128 LOP3.
//   * Raw weights, table rows and activations stream through a ring of
//     stages of 8 rows by cp.async; the words of the next stage are built
//     into a second buffer in the same step as this one's are contracted,
//     one barrier a step.  K is split across blocks to fill whole waves;
//     split blocks OR into the accumulators with atomics, an unsplit one
//     stores.  M <= 4 takes a tile of 4 rows (4 warps of one row).
//   * K4's own entry, sc_matmul(), on given planes, is the same contraction
//     with one polarity and two lookups a port pair (the top word against
//     port k, the bottom against k + K); sc_matmul_words() runs it on
//     pre-packed words.  Two launches each, no memset.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "epilogue.cuh"

// Named so a profiler trace attributes every kernel of this file, its
// finishing passes included, to it.
namespace repro_sc {
namespace {

constexpr int KEYS = 64;      // thresholds of a table row (two sequences)
constexpr int BUCKETS = 256;  // value buckets of a table row, [b / 256, (b + 1) / 256)
static_assert(BUCKETS % 64 == 0, "whole bucket words for each lane");
constexpr int MASKS_AT = KEYS;                        // word of the first mask pair
constexpr int BUCKETS_AT = MASKS_AT + 2 * (KEYS + 1);  // word of the first bucket entry
// words of a table row: 64 thresholds, 65 mask pairs, 256 16-bit bucket
// entries, 2 of padding (rows start on 16 bytes)
constexpr int ROW = BUCKETS_AT + BUCKETS / 2 + 2;
constexpr unsigned FULL = 0xffffffffu;

enum { SRC_PLANES = 0, SRC_WORDS = 1 };

// Row (k, w) of the tables, [W][K + 1][ROW].
__host__ __device__ __forceinline__ size_t table_row(int k, int w, int K) {
  return ((size_t)w * (K + 1) + k) * ROW;
}

// A total order on thresholds that agrees with <: -0.0 ties with +0.0, and
// NaN (below no probability) sorts last.
__device__ __forceinline__ uint32_t order_key(float u) {
  if (u != u) return FULL;
  const uint32_t b = __float_as_uint(u == 0.0f ? 0.0f : u);
  return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}

// The value bucket of a probability or threshold: floor(256 v), clamped
// to [0, 255] (exact: a product with 256 is exact, and the conversion rounds
// down and saturates, negative values to 0).  A NaN probability lands in
// bucket 0 (the conversion gives 0); build_tables puts NaN thresholds
// in bucket 255.
__device__ __forceinline__ int bucket_of(float v) {
  return (int)min(__float2uint_rd(v * 256.0f), (unsigned)(BUCKETS - 1));
}

// One warp per table row (k, w), k <= K: lane j holds threshold j of word w
// of sequence k (top) and of sequence k + K (bottom), or of ux twice for
// k = K.  Its rank in the row is the number of thresholds before it in the
// order (key, top before bottom, j).
__global__ void build_tables(const float* __restrict__ ux, const float* __restrict__ uw, int K,
                             int W, uint32_t* __restrict__ tab) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (K + 1) * W) return;  // whole warps
  const int w = row / (K + 1), k = row % (K + 1);
  const size_t L = 32 * (size_t)W;
  const float t = k < K ? uw[k * L + 32 * w + lane] : ux[32 * w + lane];
  const float b = k < K ? uw[(k + (size_t)K) * L + 32 * w + lane] : t;
  const uint32_t kt = order_key(t), kb = order_key(b);
  int rt = 0, rb = 0;
  for (int i = 0; i < 32; ++i) {
    const uint32_t ot = __shfl_sync(FULL, kt, i), ob = __shfl_sync(FULL, kb, i);
    rt += (ot < kt || (ot == kt && i < lane)) + (ob < kt);
    rb += (ot <= kb) + (ob < kb || (ob == kb && i < lane));
  }
  uint32_t* out = tab + table_row(k, w, K);
  reinterpret_cast<float*>(out)[rt] = t;
  reinterpret_cast<float*>(out)[rb] = b;
  // mask pairs c = lane and c = lane + 32 (and 64: every bit)
  uint32_t lo_t = 0, lo_b = 0, hi_t = 0, hi_b = 0;
  for (int j = 0; j < 32; ++j) {
    const int qt = __shfl_sync(FULL, rt, j), qb = __shfl_sync(FULL, rb, j);
    lo_t |= (uint32_t)(qt < lane) << j;
    lo_b |= (uint32_t)(qb < lane) << j;
    hi_t |= (uint32_t)(qt < lane + 32) << j;
    hi_b |= (uint32_t)(qb < lane + 32) << j;
  }
  uint2* masks = reinterpret_cast<uint2*>(out + MASKS_AT);
  masks[lane] = make_uint2(lo_t, lo_b);
  masks[lane + 32] = make_uint2(hi_t, hi_b);
  // bucket entries b = BPL lane .. BPL lane + BPL - 1: the sorted positions
  // of the bucket's first threshold and of the next bucket's, start | end << 8
  constexpr int BPL = BUCKETS / 32;
  const int bt = t != t ? BUCKETS - 1 : bucket_of(t), bb = b != b ? BUCKETS - 1 : bucket_of(b);
  int below[BPL + 1] = {};  // thresholds in buckets < BPL lane + i
  for (int j = 0; j < 32; ++j) {
    const int qt = __shfl_sync(FULL, bt, j), qb = __shfl_sync(FULL, bb, j);
#pragma unroll
    for (int i = 0; i <= BPL; ++i) below[i] += (qt < BPL * lane + i) + (qb < BPL * lane + i);
  }
  uint32_t* buckets = out + BUCKETS_AT + BPL / 2 * lane;
#pragma unroll
  for (int i = 0; i < BPL / 2; ++i)
    buckets[i] = (uint32_t)(below[2 * i] | below[2 * i + 1] << 8) |
                 (uint32_t)(below[2 * i + 1] | below[2 * i + 2] << 8) << 16;
  if (lane == 0) {
    masks[64] = make_uint2(FULL, FULL);
    out[ROW - 2] = out[ROW - 1] = 0u;
  }
}

// stream_words for the NV values v of one row at once, step by step across
// them so that their shared-memory loads are in flight together: each c
// starts at its bucket's start; two steps for every value, then more only
// while a bucket of three or more thresholds has had two below its value.
template <int NV>
__device__ __forceinline__ void row_words(const uint32_t* row, const float (&v)[NV],
                                          uint2 (&words)[NV]) {
  const float* key = reinterpret_cast<const float*>(row);
  const uint16_t* entry = reinterpret_cast<const uint16_t*>(row + BUCKETS_AT);
  int c[NV], end[NV];
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const uint32_t e = entry[bucket_of(v[q])];
    c[q] = e & 0xffu;
    end[q] = e >> 8;
  }
  bool more = false;
#pragma unroll
  for (int step = 0; step < 2; ++step)
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const bool t = c[q] < end[q] && key[c[q]] < v[q];
      c[q] += t ? 1 : 0;
      if (step == 1) more |= t && c[q] < end[q];
    }
  while (__any_sync(FULL, more)) {
    more = false;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const bool t = c[q] < end[q] && key[c[q]] < v[q];
      c[q] += t ? 1 : 0;
      more |= t && c[q] < end[q];
    }
  }
#pragma unroll
  for (int q = 0; q < NV; ++q) words[q] = reinterpret_cast<const uint2*>(row + MASKS_AT)[c[q]];
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

namespace k5 {
constexpr int BM = 4;           // activation rows of a block (the decode slots)
constexpr int CPL = 8;          // columns of a lane
constexpr int LG_TW = 8;        // columns of a warp's tile: 1 << LG_TW
constexpr int TW = 1 << LG_TW;
static_assert(TW == 32 * CPL && CPL % 4 == 0, "a warp's tile is its lanes' columns");
constexpr int WARPS = 4;        // warps, and tiles at most, of a block
constexpr int R = 4;            // plane rows (ports k, k + K) of a stage
constexpr int STAGES = 4;       // depth of the block's ring
constexpr int NT = WARPS * 32;  // threads of a block
}  // namespace k5

// One stage of the ring: rows s0 .. s0 + R - 1 of both halves for the
// block's columns, their table rows of word w, and x at their ports.
template <typename T>
struct alignas(16) Stage {
  T w[2][k5::R][k5::WARPS * k5::TW];  // [wp, wn][row][column of the block]
  uint32_t tab[k5::R][ROW];           // table rows (s0 + rr, w)
  T x[2][k5::BM][k5::R];              // [port s0 + rr, port s0 + rr + K][slot][rr]
};

// blocks an SM holds: 79 KB of shared memory a block in bf16, 145 KB in float32
#define K5_BLOCKS_PER_SM(T) (sizeof(T) == 2 ? 2 : 1)

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // bytes past src_bytes are zero-filled; with 0, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
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

// The lane's CPL adjacent values of a stage row, as floats.
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float (&v)[k5::CPL]) {
#pragma unroll
  for (int h = 0; h < k5::CPL / 4; ++h) {
    const uint2 q = reinterpret_cast<const uint2*>(p)[h];
    v[4 * h + 0] = __uint_as_float(q.x << 16);
    v[4 * h + 1] = __uint_as_float(q.x & 0xffff0000u);
    v[4 * h + 2] = __uint_as_float(q.y << 16);
    v[4 * h + 3] = __uint_as_float(q.y & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_cols(const float* p, float (&v)[k5::CPL]) {
#pragma unroll
  for (int h = 0; h < k5::CPL / 4; ++h) {
    const float4 q = reinterpret_cast<const float4*>(p)[h];
    v[4 * h + 0] = q.x, v[4 * h + 1] = q.y, v[4 * h + 2] = q.z, v[4 * h + 3] = q.w;
  }
}

// Rows [s0, s0 + R) of the block's range [.., r1) into a stage, every
// thread of the block taking its share: with VEC, cp.async copies
// (zero-filled past the range, past M and past N); without (N, K or a
// pointer not aligned for them), element loads for the planes and x.  The
// table rows always go by 16-byte copies.
template <typename T, bool VEC>
__device__ __forceinline__ void load_stage(Stage<T>& sg, const T* __restrict__ x,
                                           const T* __restrict__ wp, const T* __restrict__ wn,
                                           const uint32_t* __restrict__ tab_w, int s0, int r1,
                                           int m0, int nb, int lg_cols, int M, int N, int K,
                                           int tid) {
  using namespace k5;
  static_assert(R == 4, "4 rows a stage");
  const int rows = min(R, r1 - s0);
  for (int i = tid; i < R * ROW / 4; i += NT) {
    const bool ok = i / (ROW / 4) < rows;
    cp_async16(&sg.tab[0][0] + 4 * i, tab_w + (ok ? (size_t)s0 * ROW + 4 * i : 0), ok ? 16 : 0);
  }
  if constexpr (VEC) {
    constexpr int LG_CE = sizeof(T) == 2 ? 3 : 2;  // elements per copy: 1 << LG_CE
    const int lg_rc = lg_cols - LG_CE;            // copies per plane row: 1 << lg_rc
    for (int i = tid; i < 2 * R << lg_rc; i += NT) {
      const int pl = i >> (lg_rc + 2), rr = (i >> lg_rc) & 3, j = i & ((1 << lg_rc) - 1);
      const int n = nb + (j << LG_CE);
      const bool ok = rr < rows && n < N;
      const T* src = (pl ? wn : wp) + (ok ? (size_t)(s0 + rr) * N + n : 0);
      cp_async16(&sg.w[pl][rr][j << LG_CE], src, ok ? 16 : 0);
    }
    if (tid < 2 * BM) {  // R elements of x at one (port half, slot); K % R == 0
      const int h = tid / BM, m = tid % BM;
      const bool ok = m0 + m < M;
      const T* src = x + (ok ? (size_t)(m0 + m) * 2 * K + (size_t)h * K + s0 : 0);
      const int bytes = ok ? R * (int)sizeof(T) : 0;
      if constexpr (sizeof(T) == 2)
        cp_async8(&sg.x[h][m][0], src, bytes);
      else
        cp_async16(&sg.x[h][m][0], src, bytes);
    }
  } else {
    for (int i = tid; i < 2 * R << lg_cols; i += NT) {
      const int pl = i >> (lg_cols + 2), rr = (i >> lg_cols) & 3, j = i & ((1 << lg_cols) - 1);
      const int n = nb + j;
      sg.w[pl][rr][j] =
          rr < rows && n < N ? (pl ? wn : wp)[(size_t)(s0 + rr) * N + n] : T(0.0f);
    }
    for (int i = tid; i < 2 * BM * R; i += NT) {
      const int h = i / (BM * R), m = (i / R) % BM, rr = i % R;
      sg.x[h][m][rr] = rr < rows && m0 + m < M
                           ? x[(size_t)(m0 + m) * 2 * K + (size_t)h * K + s0 + rr]
                           : T(0.0f);
    }
  }
}

// Block (x, y, z): columns [x cols, (x + 1) cols) (cols = tpb tiles of
// TW), activation rows [4 y, 4 y + 4), word w = z % W and plane rows
// [r0, r1) of split z / W, spb stages of R rows each.  Warp v takes tile
// v % tpb and, of each stage, the rows rr = v / tpb (mod WARPS / tpb).
// For each row, a lane ORs into its accumulators, for its 8 columns:
//   w_pos: (x[m, r] & words(wp[r, n]).top) | (x[m, r + K] & words(wn[r, n]).bottom)
//   w_neg: (x[m, r] & words(wn[r, n]).top) | (x[m, r + K] & words(wp[r, n]).bottom)
template <typename T, bool VEC>
__global__ void __launch_bounds__(k5::NT, K5_BLOCKS_PER_SM(T))
    fused_contract(const T* __restrict__ x, const T* __restrict__ wp, const T* __restrict__ wn,
                   const uint32_t* __restrict__ tab, uint32_t* __restrict__ acc_p,
                   uint32_t* __restrict__ acc_n, int M, int N, int K, int W, int tpb, int spb) {
  using namespace k5;
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<T>* ring = reinterpret_cast<Stage<T>*>(smem);
  uint32_t* xrow = reinterpret_cast<uint32_t*>(smem + STAGES * sizeof(Stage<T>));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int w = blockIdx.z % W;
  const int r0 = (blockIdx.z / W) * spb * R, r1 = min(K, r0 + spb * R);
  const int m0 = blockIdx.y * BM;
  const int lg_cols = (tpb == 4 ? 2 : tpb == 2 ? 1 : 0) + LG_TW;  // tpb tiles of TW
  const int nb = blockIdx.x << lg_cols;
  const int tile = warp % tpb, phase = warp / tpb, nphase = WARPS / tpb;
  const uint32_t* tab_w = tab + table_row(0, w, K);
  const int n_st = (r1 - r0 + R - 1) / R;

  // the activation row (K, w) of the tables, in the first copy group
  for (int i = tid; i < ROW / 4; i += NT)
    cp_async16(xrow + 4 * i, tab_w + (size_t)K * ROW + 4 * i, 16);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_st)
      load_stage<T, VEC>(ring[s], x, wp, wn, tab_w, r0 + s * R, r1, m0, nb, lg_cols, M, N, K, tid);
    cp_async_commit();
  }

  uint32_t ap[BM][CPL], an[BM][CPL];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < CPL; ++c) ap[m][c] = an[m][c] = 0u;

  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage st has landed; every warp is done with stage st - 1
    const int nx = st + STAGES - 1;
    if (nx < n_st)
      load_stage<T, VEC>(ring[nx % STAGES], x, wp, wn, tab_w, r0 + nx * R, r1, m0, nb, lg_cols,
                         M, N, K, tid);
    cp_async_commit();

    const Stage<T>& sg = ring[st % STAGES];
    const int s0 = r0 + st * R;
    // the stage's activation words, one a lane: row lane / 8, port half
    // (lane / 4) % 2, slot lane % 4; zero past the range and past M
    uint32_t xw;
    {
      const int rr = lane >> 3, h = (lane >> 2) & 1, m = lane & 3;
      const float p[1] = {to_f32(sg.x[h][m][rr])};
      uint2 word[1];
      row_words(xrow, p, word);
      xw = s0 + rr < r1 && m0 + m < M ? word[0].x : 0u;
    }
    for (int rr = phase; rr < R; rr += nphase) {
      uint32_t xt[BM], xb[BM];
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        xt[m] = __shfl_sync(FULL, xw, rr * 8 + m);
        xb[m] = __shfl_sync(FULL, xw, rr * 8 + 4 + m);
      }
      if (s0 + rr >= r1) break;
      float a[CPL], b[CPL];
      load_cols(&sg.w[0][rr][tile * TW + lane * CPL], a);
      load_cols(&sg.w[1][rr][tile * TW + lane * CPL], b);
      float v[2 * CPL];
      uint2 words[2 * CPL];  // [c]: wp against ports r, r + K; [CPL + c]: wn
#pragma unroll
      for (int c = 0; c < CPL; ++c) v[c] = a[c], v[CPL + c] = b[c];
      row_words(sg.tab[rr], v, words);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const uint2 A = words[c], B = words[CPL + c];
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          ap[m][c] |= (xt[m] & A.x) | (xb[m] & B.y);
          an[m][c] |= (xt[m] & B.x) | (xb[m] & A.y);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // combine the block in shared memory, [tile][polarity][slot][column],
  // then OR it into the accumulators
  uint32_t* sum = reinterpret_cast<uint32_t*>(smem);
  const int nsum = tpb * 2 * BM * TW;
  if (nphase > 1) {
    for (int i = tid; i < nsum; i += NT) sum[i] = 0u;
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    uint32_t* sp = sum + ((tile * 2 + 0) * BM + m) * TW + lane * CPL;
    uint32_t* sn = sum + ((tile * 2 + 1) * BM + m) * TW + lane * CPL;
    if (nphase > 1) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        atomicOr(sp + c, ap[m][c]);
        atomicOr(sn + c, an[m][c]);
      }
    } else {
#pragma unroll
      for (int h = 0; h < CPL / 4; ++h) {
        reinterpret_cast<uint4*>(sp)[h] =
            make_uint4(ap[m][4 * h], ap[m][4 * h + 1], ap[m][4 * h + 2], ap[m][4 * h + 3]);
        reinterpret_cast<uint4*>(sn)[h] =
            make_uint4(an[m][4 * h], an[m][4 * h + 1], an[m][4 * h + 2], an[m][4 * h + 3]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nsum; i += NT) {
    const int t = i / (2 * BM * TW), pol = (i / (BM * TW)) % 2, m = (i / TW) % BM;
    const int n = nb + t * TW + i % TW, gm = m0 + m;
    const uint32_t v = sum[i];
    if (v && gm < M && n < N) atomicOr((pol ? acc_n : acc_p) + ((size_t)gm * N + n) * W + w, v);
  }
}

// Tiles per block, grid and stages per split for a shape: the split of K
// that keeps the most block slots of the card busy over whole waves, the
// fewer splits on a tie, each split at least 4 stages long (16 rows).
struct FusedPlan {
  int tpb, gx, gy, gz, spb;
};

FusedPlan fused_plan(int M, int N, int K, int W, int per_sm) {
  using namespace k5;
  FusedPlan p;
  const int tiles = (N + TW - 1) / TW;
  p.tpb = tiles >= 4 ? 4 : tiles >= 2 ? 2 : 1;
  p.gx = (tiles + p.tpb - 1) / p.tpb;
  p.gy = (M + BM - 1) / BM;
  const int U = (K + R - 1) / R;
  const long long base = (long long)p.gx * p.gy * W;
  const long long slots = (long long)repro_epi::sm_count() * per_sm;
  const int max_splits = std::max(1, std::min((U + 3) / 4, (int)(4 * slots / base) + 1));
  double best = -1.0;
  for (int splits = 1; splits <= max_splits; ++splits) {
    const int spb = (U + splits - 1) / splits;
    const int gz = (U + spb - 1) / spb;
    const long long waves = (base * gz + slots - 1) / slots;
    const double use = (double)base * U / ((double)waves * slots * spb);
    if (use > best + 1e-9) {
      best = use;
      p.spb = spb;
      p.gz = gz * W;
    }
  }
  return p;
}

template <typename T, bool VEC>
void launch_fused(const T* x, const T* wp, const T* wn, const uint32_t* tab, uint32_t* acc_p,
                  uint32_t* acc_n, int M, int N, int K, int W, cudaStream_t st) {
  const FusedPlan p = fused_plan(M, N, K, W, K5_BLOCKS_PER_SM(T));
  const int smem = k5::STAGES * (int)sizeof(Stage<T>) + ROW * (int)sizeof(uint32_t);
  static bool attr = [smem] {
    cudaFuncSetAttribute(fused_contract<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    cudaFuncSetAttribute(fused_contract<T, VEC>, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    return true;
  }();
  (void)attr;
  fused_contract<T, VEC><<<dim3(p.gx, p.gy, p.gz), k5::NT, smem, st>>>(
      x, wp, wn, tab, acc_p, acc_n, M, N, K, W, p.tpb, p.spb);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename T>
void run_fused(const void* x, const void* wp, const void* wn, const uint32_t* tab,
               uint32_t* acc_p, uint32_t* acc_n, int M, int N, int K, int W, cudaStream_t st) {
  constexpr int CE = 16 / sizeof(T);
  // 16-byte copies of plane rows, R-element copies of x
  const bool vec = N % CE == 0 && K % k5::R == 0 && aligned(wp, 16) && aligned(wn, 16) &&
                   aligned(x, k5::R * sizeof(T));
  const T* xt = static_cast<const T*>(x);
  const T* a = static_cast<const T*>(wp);
  const T* b = static_cast<const T*>(wn);
  if (vec)
    launch_fused<T, true>(xt, a, b, tab, acc_p, acc_n, M, N, K, W, st);
  else
    launch_fused<T, false>(xt, a, b, tab, acc_p, acc_n, M, N, K, W, st);
}

// K5's value before the epilogue: (count_p / bits - count_n / bits) times
// the row's prescale, rounded to the output type.  The finishing pass
// releases each output after its last read: its accumulator words are
// zeroed, ready for the next call.
template <typename T>
struct PlaneDifference {
  uint32_t* acc_p;
  uint32_t* acc_n;
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
  __device__ void release(size_t i) const {
    for (int w = 0; w < W; ++w) acc_p[i * W + w] = acc_n[i * W + w] = 0u;
  }
};

// ---------------------------------------------------------------------------
// K4 and the SC prefill projection
// ---------------------------------------------------------------------------

enum { K4_QUANT = 0, K4_PLANES = 1, K4_WORDS = 2 };

namespace k4 {
constexpr int BN = 128;  // columns of a block
constexpr int CPT = 4;   // columns of a thread: lane + 32 j, j < CPT
static_assert(BN == 32 * CPT, "a warp's lanes take the block's columns");
constexpr int R = 8;     // rows (ports k) of a stage
constexpr int SCALE_NT = 256;  // threads of a scale-pass block
// the scale pass's results, float32 words
constexpr int SC_QW = 0;       // rnd(g / sw)
constexpr int SC_QX = 1;       // rnd(g / sx)
constexpr int SC_RESCALE = 2;  // rnd(rnd(sx sw) / rnd(g g))
}  // namespace k4

// stages of the ring: 3 for float32 operands, so two blocks fit an SM
template <typename T>
__host__ __device__ constexpr int k4_stages() {
  return sizeof(T) == 2 ? 4 : 3;
}

// One stage of the ring: rows s0 .. s0 + R - 1 of the block's columns, the
// table rows (s0 + r, w) of the stream word the block builds, and the
// activations at those ports.  K4_QUANT: the raw weights w and x [M, K];
// K4_PLANES: the two plane halves and both halves of x [M, 2K]; K4_WORDS:
// pre-packed words (no tables).
template <int MODE, typename T, int BM>
struct alignas(16) K4Stage {
  static constexpr int PL = MODE == K4_PLANES ? 2 : 1;
  using E = std::conditional_t<MODE == K4_WORDS, uint32_t, T>;
  E w[PL][k4::R][k4::BN];
  uint32_t tab[MODE == K4_WORDS ? 1 : k4::R][ROW];
  E x[PL][BM][k4::R];  // [port half][row][r]
};

// A probability plane's value of v = w q where v is not zero: |v|, clamped
// to 1 (NaN stays NaN, as the plane's clamp leaves it).
__device__ __forceinline__ float unit(float v) {
  const float a = fabsf(v);
  return a > 1.0f ? 1.0f : a;
}

// Rows [s0, s0 + R) of the split's range [.., r1) into a stage, every
// thread taking its share: with VEC, 16-byte cp.async copies (zero-filled
// past the range, past M and past N; needs N and K multiples of a copy and
// of R); without, element loads.  The table rows always go by 16-byte
// copies.  nk: 0 for weights [K, N] row-major; K for K4_QUANT's w given as
// [N, K] row-major (a tied LM head reads the embedding in place), whose
// element loads take consecutive rows of one column in consecutive
// threads.
template <int MODE, typename T, int BM, int NT, bool VEC>
__device__ __forceinline__ void k4_load_stage(K4Stage<MODE, T, BM>& sg, const T* __restrict__ x,
                                              const T* __restrict__ wa, const T* __restrict__ wb,
                                              const uint32_t* __restrict__ xbits,
                                              const uint32_t* __restrict__ wbits,
                                              const uint32_t* __restrict__ tab_w, int s0, int r1,
                                              int m0, int n0, int M, int N, int K, int W, int w,
                                              int tid, int nk) {
  using namespace k4;
  constexpr int PL = K4Stage<MODE, T, BM>::PL;
  const int rows = min(R, r1 - s0);
  if constexpr (MODE == K4_WORDS) {
    for (int i = tid; i < R * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      sg.w[0][r][c] = r < rows && n0 + c < N ? wbits[((size_t)(s0 + r) * N + n0 + c) * W + w] : 0u;
    }
    for (int i = tid; i < BM * R; i += NT) {
      const int m = i / R, r = i % R;
      sg.x[0][m][r] =
          r < rows && m0 + m < M ? xbits[((size_t)(m0 + m) * K + s0 + r) * W + w] : 0u;
    }
    return;
  } else {
    for (int i = tid; i < R * ROW / 4; i += NT) {
      const bool ok = i / (ROW / 4) < rows;
      cp_async16(&sg.tab[0][0] + 4 * i, tab_w + (ok ? (size_t)s0 * ROW + 4 * i : 0), ok ? 16 : 0);
    }
    // x's row stride, and where its second half starts
    const size_t xs = MODE == K4_QUANT ? (size_t)K : 2 * (size_t)K;
    if constexpr (VEC) {
      constexpr int CE = 16 / sizeof(T);  // elements a copy
      constexpr int RC = BN / CE;         // copies a plane row
      for (int i = tid; i < PL * R * RC; i += NT) {
        const int pl = i / (R * RC), r = (i / RC) % R, j = i % RC;
        const int n = n0 + j * CE;
        const bool ok = r < rows && n < N;
        const T* src = (pl ? wb : wa) + (ok ? (size_t)(s0 + r) * N + n : 0);
        cp_async16(&sg.w[pl][r][j * CE], src, ok ? 16 : 0);
      }
      constexpr int XC = R / CE;  // copies of a row's R activations
      for (int i = tid; i < PL * BM * XC; i += NT) {
        const int h = i / (BM * XC), m = (i / XC) % BM, c = i % XC;
        const bool ok = m0 + m < M;  // K % R == 0: the R ports lie inside x
        const T* src = x + (ok ? (size_t)(m0 + m) * xs + (size_t)h * K + s0 + c * CE : 0);
        cp_async16(&sg.x[h][m][c * CE], src, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < PL * R * BN; i += NT) {
        const int pl = i / (R * BN), j = i % (R * BN);
        const int r = nk ? j % R : j / BN, c = nk ? j / R : j % BN;
        const size_t at = nk ? (size_t)(n0 + c) * nk + s0 + r : (size_t)(s0 + r) * N + n0 + c;
        sg.w[pl][r][c] = r < rows && n0 + c < N ? (pl ? wb : wa)[at] : T(0.0f);
      }
      for (int i = tid; i < PL * BM * R; i += NT) {
        const int h = i / (BM * R), m = (i / R) % BM, r = i % R;
        sg.x[h][m][r] = r < rows && m0 + m < M
                            ? x[(size_t)(m0 + m) * xs + (size_t)h * K + s0 + r]
                            : T(0.0f);
      }
    }
  }
}

// The words of a stage, built from its landed data into the second
// buffer: for each row r and column c, the weight's words (wq: the four of
// the two polarities; w2: one polarity's two), and for each row r and
// activation row m the activation words (xt against port k, xb against
// port k + K).
//   K4_QUANT: v = rnd(w qw); the plane that holds v is min(|v|, 1) and the
//     other is 0, so one lookup gives the non-zero plane's words against
//     ports k and k + K, and the zero plane's are the row's words of 0
//     (z, none unless a threshold is below 0).  Activations likewise with
//     qx against the activation row (zx: its words of 0).
//   K4_PLANES: the two halves' words, top against port k, bottom against
//     port k + K (two lookups a pair); activations of both halves.
//   K4_WORDS: the words themselves (one port a row; xb and the bottom
//     word 0).
template <int MODE, typename T, int BM, int RW>
__device__ __forceinline__ void k4_build(const K4Stage<MODE, T, BM>& sg, void* wbuf,
                                         uint2 (*xw)[BM], const uint32_t* xrow, uint2 zx,
                                         float qw, float qx, int warp, int lane, int tid) {
  using namespace k4;
  constexpr int NT = 32 * RW;
  if constexpr (MODE == K4_QUANT) {
    uint4(*wq)[BN] = reinterpret_cast<uint4(*)[BN]>(wbuf);
    for (int r = warp; r < R; r += RW) {
      float v[CPT], p[CPT + 1];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        v[j] = repro_epi::rnd<T>(__fmul_rn(to_f32(sg.w[0][r][lane + 32 * j]), qw));
        p[j] = unit(v[j]);
      }
      p[CPT] = 0.0f;
      uint2 a[CPT + 1];
      row_words(sg.tab[r], p, a);
      const uint2 z = a[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        // (wp at port k, wn at port k + K, wn at port k, wp at port k + K)
        wq[r][lane + 32 * j] =
            make_uint4(v[j] < 0.0f ? z.x : a[j].x, v[j] > 0.0f ? z.y : a[j].y,
                       v[j] > 0.0f ? z.x : a[j].x, v[j] < 0.0f ? z.y : a[j].y);
      }
    }
  } else if constexpr (MODE == K4_PLANES) {
    uint2(*w2)[BN] = reinterpret_cast<uint2(*)[BN]>(wbuf);
    for (int r = warp; r < R; r += RW) {
      float p[2 * CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        p[j] = to_f32(sg.w[0][r][lane + 32 * j]);
        p[CPT + j] = to_f32(sg.w[1][r][lane + 32 * j]);
      }
      uint2 a[2 * CPT];
      row_words(sg.tab[r], p, a);
#pragma unroll
      for (int j = 0; j < CPT; ++j) w2[r][lane + 32 * j] = make_uint2(a[j].x, a[CPT + j].y);
    }
  } else {
    uint2(*w2)[BN] = reinterpret_cast<uint2(*)[BN]>(wbuf);
    for (int i = tid; i < R * BN; i += NT)
      w2[i / BN][i % BN] = make_uint2(sg.w[0][i / BN][i % BN], 0u);
  }
  // activations: whole warps through row_words, so the loop runs the same
  // count on every lane
  constexpr int NX = BM * R;
  for (int base = 0; base < NX; base += NT) {
    const int i = base + tid, m = i % BM, r = i / BM;
    const bool in = i < NX;
    if constexpr (MODE == K4_WORDS) {
      if (in) xw[r][m] = make_uint2(sg.x[0][m][r], 0u);
    } else if constexpr (MODE == K4_QUANT) {
      const float xv = in ? repro_epi::rnd<T>(__fmul_rn(to_f32(sg.x[0][m][r]), qx)) : 0.0f;
      const float p[1] = {unit(xv)};
      uint2 a[1];
      row_words(xrow, p, a);
      if (in) xw[r][m] = make_uint2(xv < 0.0f ? zx.x : a[0].x, xv > 0.0f ? zx.x : a[0].x);
    } else {
      const float p[2] = {in ? to_f32(sg.x[0][m][r]) : 0.0f, in ? to_f32(sg.x[1][m][r]) : 0.0f};
      uint2 a[2];
      row_words(xrow, p, a);
      if (in) xw[r][m] = make_uint2(a[0].x, a[1].x);
    }
  }
}

// One stage's OR of ANDs into a thread's accumulators: rows TM rg .. of
// the block, columns lane + 32 j.  Two LOP3 a row, column and polarity.
template <int POL, int BM, int TM>
__device__ __forceinline__ void k4_contract_stage(const void* wbuf, const uint2 (*xw)[BM],
                                                  uint32_t (&ap)[TM][k4::CPT],
                                                  uint32_t (&an)[TM][k4::CPT], int rg, int lane) {
  using namespace k4;
#pragma unroll 2
  for (int r = 0; r < R; ++r) {
    uint32_t xt[TM], xb[TM];
    if constexpr (TM % 2 == 0) {
      const uint4* q = reinterpret_cast<const uint4*>(&xw[r][rg * TM]);
#pragma unroll
      for (int h = 0; h < TM / 2; ++h) {
        const uint4 u = q[h];
        xt[2 * h] = u.x, xb[2 * h] = u.y, xt[2 * h + 1] = u.z, xb[2 * h + 1] = u.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) xt[i] = xw[r][rg * TM + i].x, xb[i] = xw[r][rg * TM + i].y;
    }
    // a weight word's LOP3 one after the other across the rows, so that
    // consecutive instructions share an operand (15% faster at gate/up than
    // a row's four LOP3 in a row, in turns on the card)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      if constexpr (POL == 2) {
        const uint4 q = reinterpret_cast<const uint4(*)[BN]>(wbuf)[r][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i) ap[i][j] = (xt[i] & q.x) | ap[i][j];
#pragma unroll
        for (int i = 0; i < TM; ++i) an[i][j] = (xt[i] & q.z) | an[i][j];
#pragma unroll
        for (int i = 0; i < TM; ++i) ap[i][j] = (xb[i] & q.y) | ap[i][j];
#pragma unroll
        for (int i = 0; i < TM; ++i) an[i][j] = (xb[i] & q.w) | an[i][j];
      } else {
        const uint2 q = reinterpret_cast<const uint2(*)[BN]>(wbuf)[r][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i) ap[i][j] = (xt[i] & q.x) | ap[i][j];
#pragma unroll
        for (int i = 0; i < TM; ++i) ap[i][j] = (xb[i] & q.y) | ap[i][j];
      }
    }
  }
}

struct K4Args {
  const void* x;           // K4_QUANT: x [M, K]; K4_PLANES: x [M, 2K]
  const void* wa;          // K4_QUANT: w [K, N]; K4_PLANES: the top half [K, N]
  const void* wb;          // K4_PLANES: the bottom half [K, N]
  const uint32_t* xbits;   // K4_WORDS: [M, K, W]
  const uint32_t* wbits;   // K4_WORDS: [K, N, W]
  const uint32_t* tab;     // the tables (sc_tables)
  const float* scales;     // K4_QUANT: the scale pass's results
  uint32_t* acc_p;         // [M, N, W] words, all zero on entry when split
  uint32_t* acc_n;         // K4_QUANT: the negative polarity's
  int M, N, K, W;          // K: port pairs (K4_WORDS: ports)
  int spb;                 // stages of a split
  int split;               // more than one split: OR into acc with atomics
  int nk;                  // K4_QUANT: K for w given as [N, K] row-major, else 0
};

// Block (x, y, z): columns [128 x, 128 x + 128), rows [BM y, BM y + BM),
// stream word w = z % W and rows [r0, r1) of split z / W, spb stages of R
// rows.  Warp v takes the block's rows TM v .. TM v + TM - 1; its lane the
// columns lane + 32 j.  A ring of stages by cp.async, and two buffers of
// built words: after the one barrier of a step, the words of the next
// stage are built while those of this one are contracted.
template <int MODE, typename T, int TM, int RW, bool VEC>
__global__ void __launch_bounds__(32 * RW, 2) k4_contract(K4Args a) {
  using namespace k4;
  constexpr int NT = 32 * RW, BM = TM * RW, POL = MODE == K4_QUANT ? 2 : 1;
  constexpr int S = k4_stages<T>();
  using Stg = K4Stage<MODE, T, BM>;
  using WE = std::conditional_t<POL == 2, uint4, uint2>;
  extern __shared__ __align__(16) unsigned char smem[];
  Stg* ring = reinterpret_cast<Stg*>(smem);
  unsigned char* wbuf = smem + S * sizeof(Stg);  // [2][R][BN] WE
  uint2(*xbuf)[R][BM] = reinterpret_cast<uint2(*)[R][BM]>(wbuf + 2 * R * BN * sizeof(WE));
  uint32_t* xrow = reinterpret_cast<uint32_t*>(xbuf + 2);  // the activation row (K, w)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int W = a.W, K = a.K, M = a.M, N = a.N;
  const int w = blockIdx.z % W;
  const int r0 = (blockIdx.z / W) * a.spb * R, r1 = min(K, r0 + a.spb * R);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_st = (r1 - r0 + R - 1) / R;
  const uint32_t* tab_w = MODE == K4_WORDS ? nullptr : a.tab + table_row(0, w, K);
  const T* x = static_cast<const T*>(a.x);
  const T* wa = static_cast<const T*>(a.wa);
  const T* wb = static_cast<const T*>(a.wb);
  auto load = [&](int s) {
    k4_load_stage<MODE, T, BM, NT, VEC>(ring[s % S], x, wa, wb, a.xbits, a.wbits, tab_w,
                                        r0 + s * R, r1, m0, n0, M, N, K, W, w, tid, a.nk);
  };

  if constexpr (MODE != K4_WORDS)
    for (int i = tid; i < ROW / 4; i += NT)
      cp_async16(xrow + 4 * i, tab_w + (size_t)K * ROW + 4 * i, 16);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_st) load(s);
    cp_async_commit();
  }
  float qw = 0.0f, qx = 0.0f;
  if constexpr (MODE == K4_QUANT) qw = a.scales[SC_QW], qx = a.scales[SC_QX];
  cp_async_wait<S - 2>();
  __syncthreads();  // stage 0 and the activation row have landed
  uint2 zx = make_uint2(0u, 0u);
  if constexpr (MODE != K4_WORDS) {
    const float p[1] = {0.0f};
    uint2 z[1];
    row_words(xrow, p, z);
    zx = z[0];
  }
  k4_build<MODE, T, BM, RW>(ring[0], wbuf, xbuf[0], xrow, zx, qw, qx, warp, lane, tid);

  uint32_t ap[TM][CPT], an[TM][CPT];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) ap[i][j] = an[i][j] = 0u;

  for (int s = 0; s < n_st; ++s) {
    if (s + S - 1 < n_st) load(s + S - 1);  // into the slot stage s - 1 left
    cp_async_commit();
    cp_async_wait<S - 2>();
    __syncthreads();  // stage s + 1 has landed; stage s's words are built; s - 1's are done
    // even warps build first, odd ones contract first: while some wait on
    // the lookups' loads, the others keep the ALU pipe busy
    if (warp & 1)
      k4_contract_stage<POL, BM, TM>(wbuf + (s & 1) * R * BN * sizeof(WE), xbuf[s & 1], ap, an,
                                     warp, lane);
    if (s + 1 < n_st)
      k4_build<MODE, T, BM, RW>(ring[(s + 1) % S], wbuf + ((s + 1) & 1) * R * BN * sizeof(WE),
                                xbuf[(s + 1) & 1], xrow, zx, qw, qx, warp, lane, tid);
    if (!(warp & 1))
      k4_contract_stage<POL, BM, TM>(wbuf + (s & 1) * R * BN * sizeof(WE), xbuf[s & 1], ap, an,
                                     warp, lane);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + warp * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int gn = n0 + lane + 32 * j;
      if (gn >= N) continue;
      const size_t o = ((size_t)gm * N + gn) * W + w;
      if (a.split) {
        atomicOr(a.acc_p + o, ap[i][j]);
        if constexpr (POL == 2) atomicOr(a.acc_n + o, an[i][j]);
      } else {
        a.acc_p[o] = ap[i][j];
        if constexpr (POL == 2) a.acc_n[o] = an[i][j];
      }
    }
  }
}

template <int MODE, typename T, int TM, int RW, bool VEC>
int k4_smem() {
  constexpr int POL = MODE == K4_QUANT ? 2 : 1;
  return k4_stages<T>() * (int)sizeof(K4Stage<MODE, T, TM * RW>) +
         2 * k4::R * k4::BN * (POL == 2 ? 16 : 8) + 2 * k4::R * TM * RW * 8 + ROW * 4;
}

// The split of K that keeps the most block slots of the card busy over
// whole waves (the fewer splits on a tie), each split at least 4 stages.
template <int MODE, typename T, int TM, int RW, bool VEC>
void launch_k4(K4Args a, cudaStream_t st) {
  constexpr int BM = TM * RW;
  const int smem = k4_smem<MODE, T, TM, RW, VEC>();
  static const int per_sm = [smem] {
    cudaFuncSetAttribute(k4_contract<MODE, T, TM, RW, VEC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(k4_contract<MODE, T, TM, RW, VEC>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k4_contract<MODE, T, TM, RW, VEC>, 32 * RW,
                                                  smem);
    return n > 0 ? n : 1;
  }();
  const int gx = (a.N + k4::BN - 1) / k4::BN, gy = (a.M + BM - 1) / BM;
  const int U = (a.K + k4::R - 1) / k4::R;
  const long long base = (long long)gx * gy * a.W;
  const long long slots = (long long)repro_epi::sm_count() * per_sm;
  const int max_splits = std::max(1, std::min((U + 3) / 4, (int)(4 * slots / base) + 1));
  double best = -1.0;
  int gz = 1;
  for (int splits = 1; splits <= max_splits; ++splits) {
    const int spb = (U + splits - 1) / splits;
    const int z = (U + spb - 1) / spb;
    const long long waves = (base * z + slots - 1) / slots;
    const double use = (double)base * U / ((double)waves * slots * spb);
    if (use > best + 1e-9) {
      best = use;
      a.spb = spb;
      gz = z;
    }
  }
  a.split = gz > 1;
  k4_contract<MODE, T, TM, RW, VEC><<<dim3(gx, gy, gz * a.W), 32 * RW, smem, st>>>(a);
}

// 64 rows a block (8 warps of 8 rows), or 4 for M <= 4 (4 warps of one).
template <int MODE, typename T, bool VEC>
void k4_rows(const K4Args& a, cudaStream_t st) {
  if (a.M <= 4)
    launch_k4<MODE, T, 1, 4, VEC>(a, st);
  else
    launch_k4<MODE, T, 8, 8, VEC>(a, st);
}

template <int MODE, typename T>
void run_k4(const K4Args& a, cudaStream_t st) {
  constexpr int CE = 16 / sizeof(T);
  const bool vec = !a.nk && a.N % CE == 0 && a.K % k4::R == 0 && aligned(a.x, 16) &&
                   aligned(a.wa, 16) && (MODE == K4_QUANT || aligned(a.wb, 16));
  if (vec)
    k4_rows<MODE, T, true>(a, st);
  else
    k4_rows<MODE, T, false>(a, st);
}

// |v| as the bit pattern of a float: its order is that of |v| (NaN above
// every number, as a max with NaN is NaN).
__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(v) & 0x7fffffffu; }
__device__ __forceinline__ unsigned abs_bits(__nv_bfloat16 v) {
  return (unsigned)(__bfloat16_as_ushort(v) & 0x7fffu) << 16;
}

// The max of 16 bytes, as abs_bits.
__device__ __forceinline__ unsigned abs_max16(uint4 q, __nv_bfloat16) {
  const unsigned h = __vmaxu2(__vmaxu2(q.x & 0x7fff7fffu, q.y & 0x7fff7fffu),
                              __vmaxu2(q.z & 0x7fff7fffu, q.w & 0x7fff7fffu));
  return max(h << 16, h & 0xffff0000u);
}
__device__ __forceinline__ unsigned abs_max16(uint4 q, float) {
  return max(max(q.x & 0x7fffffffu, q.y & 0x7fffffffu), max(q.z & 0x7fffffffu, q.w & 0x7fffffffu));
}

// The scale pass of the prefill projection: blocks [0, xblocks) take
// grid-stride shares of x, the rest of w (with VEC, 16 bytes a load, four
// loads in flight a thread).  Each block adds its max into hold (atomicMax
// of abs_bits: hold[1] for x, hold[2] for w), then counts itself in
// hold[0]; the last block to count reads the maxima, floors them at eps
// (sx, sw, as tensor_scale), and writes rnd(g / sw), rnd(g / sx) and the
// rescale rnd(rnd(sx sw) / gg), every op rounded to T as the plain version
// rounds it; and zeroes hold.
template <typename T, bool VEC>
__global__ void __launch_bounds__(k4::SCALE_NT)
    sc_scale_pass(const T* __restrict__ x, const T* __restrict__ w, unsigned* __restrict__ hold,
                  float* __restrict__ scales, size_t MK, size_t KN, int xblocks, float eps,
                  float gain, float gain2) {
  using namespace k4;
  __shared__ unsigned red[SCALE_NT / 32];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const bool is_x = (int)blockIdx.x < xblocks;
  unsigned mx = 0u;
  if (is_x) {
    const size_t stride = (size_t)xblocks * SCALE_NT;
    for (size_t i = blockIdx.x * (size_t)SCALE_NT + tid; i < MK; i += stride)
      mx = max(mx, abs_bits(x[i]));
  } else {
    const int wblocks = gridDim.x - xblocks;
    const size_t stride = (size_t)wblocks * SCALE_NT;
    size_t i = (blockIdx.x - xblocks) * (size_t)SCALE_NT + tid;
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
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(FULL, mx, o));
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int j = 1; j < SCALE_NT / 32; ++j) mx = max(mx, red[j]);
    atomicMax(hold + (is_x ? 1 : 2), mx);
    __threadfence();  // the max lands before the count
    last = atomicAdd(hold, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || tid != 0) return;
  __threadfence();
  // every other block has added its max: read them, and leave hold zero
  const unsigned eps_bits = __float_as_uint(eps);
  const float sx = __uint_as_float(max(atomicExch(hold + 1, 0u), eps_bits));
  const float sw = __uint_as_float(max(atomicExch(hold + 2, 0u), eps_bits));
  scales[SC_QW] = repro_epi::rnd<T>(__fdiv_rn(gain, sw));
  scales[SC_QX] = repro_epi::rnd<T>(__fdiv_rn(gain, sx));
  scales[SC_RESCALE] =
      repro_epi::rnd<T>(__fdiv_rn(repro_epi::rnd<T>(__fmul_rn(sx, sw)), gain2));
  atomicExch(hold, 0u);
}

template <typename T>
void run_scales(const void* x, const void* w, unsigned* hold, float* scales, int M, int K, int N,
                float eps, float gain, float gain2, cudaStream_t st) {
  const size_t KN = (size_t)K * N, MK = (size_t)M * K;
  const bool vec = KN * sizeof(T) % 16 == 0 && aligned(w, 16);
  const size_t per_block = (size_t)k4::SCALE_NT * (vec ? 4 * 16 / sizeof(T) : 4);
  const int sms = repro_epi::sm_count();
  const int wblocks = (int)std::max<size_t>(
      1, std::min<size_t>((KN + per_block - 1) / per_block, (size_t)sms * 8));
  const int xblocks = (int)std::max<size_t>(
      1, std::min<size_t>((MK + 4 * k4::SCALE_NT - 1) / (4 * k4::SCALE_NT), (size_t)sms));
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  if (vec)
    sc_scale_pass<T, true><<<xblocks + wblocks, k4::SCALE_NT, 0, st>>>(
        xt, wt, hold, scales, MK, KN, xblocks, eps, gain, gain2);
  else
    sc_scale_pass<T, false><<<xblocks + wblocks, k4::SCALE_NT, 0, st>>>(
        xt, wt, hold, scales, MK, KN, xblocks, eps, gain, gain2);
}

// K4's value: popcount / bits of each output's words, which it then clears.
struct PlaneCount {
  uint32_t* acc;
  int W;
  float bits;
  __device__ float operator()(size_t i, int) const {
    int c = 0;
    for (int w = 0; w < W; ++w) c += __popc(acc[i * W + w]);
    return __fdiv_rn(__int2float_rn(c), bits);
  }
  __device__ void release(size_t i) const {
    for (int w = 0; w < W; ++w) acc[i * W + w] = 0u;
  }
};

// The prefill projection's value: (count_p / bits - count_n / bits) times
// the scale pass's rescale, rounded to the output type; it clears the
// words it has read.
template <typename T>
struct PrefillDifference {
  uint32_t* acc_p;
  uint32_t* acc_n;
  int W;
  float bits;
  const float* scales;
  __device__ float operator()(size_t i, int) const {
    int cp = 0, cn = 0;
    for (int w = 0; w < W; ++w) {
      cp += __popc(acc_p[i * W + w]);
      cn += __popc(acc_n[i * W + w]);
    }
    const float r = __fsub_rn(__fdiv_rn(__int2float_rn(cp), bits),
                              __fdiv_rn(__int2float_rn(cn), bits));
    return repro_epi::rnd<T>(__fmul_rn(r, scales[k4::SC_RESCALE]));
  }
  __device__ void release(size_t i) const {
    for (int w = 0; w < W; ++w) acc_p[i * W + w] = acc_n[i * W + w] = 0u;
  }
};

}  // namespace
}  // namespace repro_sc

using namespace repro_sc;

// Threshold tables of the draws ux [bits] (shared by every activation port)
// and uw [2K, bits] (one sequence per weight port): tab, (K + 1) * W rows
// of ROW words, W = bits / 32 (see the note at the top).
extern "C" int sc_tables(const float* ux, const float* uw, uint32_t* tab, int K, int bits,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = (K + 1) * (bits / 32);
  build_tables<<<(rows + 3) / 4, 128, 0, st>>>(ux, uw, K, bits / 32, tab);
  return (int)cudaGetLastError();
}

// K4: out[M,N] (float32) = popcount(OR_k(xs[m,k] & ws[k,n])) / bits over the
// 2K ports, where xs are the streams of x [M, 2K] and ws those of the plane
// [wa; wb] ([K, N] each), against the tables tab of their draws
// (sc_tables).  x, wa, wb: float32 or bfloat16 probabilities.  acc: M*N*W
// words, W = bits / 32, all zero on entry, and left all zero.  Two
// launches.
extern "C" int sc_matmul(int in_bf16, const void* x, const void* wa, const void* wb,
                         const uint32_t* tab, uint32_t* acc, float* out, int M, int N, int K,
                         int bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = bits / 32;
  const K4Args a{x, wa, wb, nullptr, nullptr, tab, nullptr, acc, nullptr, M, N, K, W, 0, 0, 0};
  if (in_bf16)
    run_k4<K4_PLANES, __nv_bfloat16>(a, st);
  else
    run_k4<K4_PLANES, float>(a, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;  // not launched: the accumulators are untouched
  repro_epi::finish<float>(PlaneCount{acc, W, (float)bits}, nullptr, nullptr, nullptr, 0,
                           0.0f, out, M, N, st);
  return (int)cudaGetLastError();
}

// K4 on pre-packed words, the reference kernel's own interface:
// out[M,N] = popcount(OR_k(xbits[m,k,:] & wbits[k,n,:])) / bits over P
// ports, through the same contraction.  acc as for sc_matmul.
extern "C" int sc_matmul_words(const uint32_t* xbits, const uint32_t* wbits, uint32_t* acc,
                               float* out, int M, int N, int P, int bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = bits / 32;
  const K4Args a{nullptr, nullptr, nullptr, xbits, wbits, nullptr, nullptr, acc, nullptr,
                 M, N, P, W, 0, 0, 0};
  k4_rows<K4_WORDS, float, false>(a, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  repro_epi::finish<float>(PlaneCount{acc, W, (float)bits}, nullptr, nullptr, nullptr, 0,
                           0.0f, out, M, N, st);
  return (int)cudaGetLastError();
}

// The SC prefill projection from the operands themselves, x [M, K] and w
// [K, N] (float32 or bfloat16; w_nk = 1: w given as its transpose [N, K]
// row-major, read in place, as a tied LM head reads the embedding): the
// planes of the SC emulator (scales sx,
// sw floored at eps; q = rnd(gain / s); planes clamp(max(+-rnd(v q), 0), 0,
// 1)), both polarities w_pos = [wp; wn] and w_neg = [wn; wp] against the
// streams of the tables tab (sc_tables), then ((count_p / bits - count_n /
// bits) * rnd(rnd(sx sw) / gain2)) cast to the operand type.  gain, gain2 =
// gain^2 and eps come rounded to that type.  hold: 3 words, and acc_p,
// acc_n: M*N*W words each, all zero on entry and left all zero; scales: 3
// floats of scratch.  Three launches: the scale pass, the contraction, the
// finishing pass.
extern "C" int sc_matmul_quantized(int in_bf16, const void* x, const void* w,
                                   const uint32_t* tab, unsigned* hold, float* scales,
                                   uint32_t* acc_p, uint32_t* acc_n, void* out, int M, int N,
                                   int K, int bits, float eps, float gain, float gain2, int w_nk,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = bits / 32;
  const K4Args a{x,     w,     nullptr, nullptr, nullptr, tab, scales, acc_p,
                 acc_n, M,     N,       K,       W,       0,   0,      w_nk ? K : 0};
  if (in_bf16) {
    run_scales<__nv_bfloat16>(x, w, hold, scales, M, K, N, eps, gain, gain2, st);
    run_k4<K4_QUANT, __nv_bfloat16>(a, st);
  } else {
    run_scales<float>(x, w, hold, scales, M, K, N, eps, gain, gain2, st);
    run_k4<K4_QUANT, float>(a, st);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (in_bf16)
    repro_epi::finish<__nv_bfloat16>(
        PrefillDifference<__nv_bfloat16>{acc_p, acc_n, W, (float)bits, scales}, nullptr,
        nullptr, nullptr, 0, 0.0f, out, M, N, st);
  else
    repro_epi::finish<float>(PrefillDifference<float>{acc_p, acc_n, W, (float)bits, scales},
                             nullptr, nullptr, nullptr, 0, 0.0f, out, M, N, st);
  return (int)cudaGetLastError();
}

// K5: both polarities, w_pos = [wp; wn] and w_neg = [wn; wp], against the
// streams of the tables tab (sc_tables); then ((count_p / bits - count_n /
// bits) * pre[m]) cast to the output type, then the epilogue as in K2
// (chip term when add != NULL, then the correction polynomial when P > 0).
// acc_p, acc_n: M*N*W words each, all zero on entry, and left all zero.
// Two launches.
extern "C" int sc_matmul_fused(int in_bf16, int out_bf16, const void* x, const void* wp,
                               const void* wn, const uint32_t* tab, uint32_t* acc_p,
                               uint32_t* acc_n, const float* pre, const void* gain,
                               const void* add, const float* coeffs, int P, float eps,
                               void* out, int M, int N, int K, int bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = bits / 32;
  if (in_bf16)
    run_fused<__nv_bfloat16>(x, wp, wn, tab, acc_p, acc_n, M, N, K, W, st);
  else
    run_fused<float>(x, wp, wn, tab, acc_p, acc_n, M, N, K, W, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;  // not launched: the accumulators are untouched
  if (out_bf16)
    repro_epi::finish<__nv_bfloat16>(
        PlaneDifference<__nv_bfloat16>{acc_p, acc_n, W, (float)bits, pre}, gain, add, coeffs, P,
        eps, out, M, N, st);
  else
    repro_epi::finish<float>(PlaneDifference<float>{acc_p, acc_n, W, (float)bits, pre}, gain,
                             add, coeffs, P, eps, out, M, N, st);
  return (int)cudaGetLastError();
}

extern "C" const char* sc_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
