// Stochastic-computing contractions on Hopper CUDA cores: kernels K4 and K5.
//
// Replaces the Pallas TPU kernels repro/kernels/sc_matmul.py:
//   sc_matmul_packed        (_kernel)       -> sc_matmul(), sc_matmul_words()
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
// layers (repro_torch.core.approx_linear.ApproxCtx), and across the two K4
// calls of a prefill projection.
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
// K4 (prefill, M = 64) keeps its tiled contraction: a block stages a tile
// of probabilities and builds their words in shared memory, a thread the
// words of 8 columns of one row at once, K split across blocks when the
// output tiles alone cannot fill the SMs.  sc_matmul_words() runs it on
// pre-packed words.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "epilogue.cuh"

// Named so a profiler trace attributes every kernel of this file, its
// finishing passes included, to it.
namespace repro_sc {
namespace {

constexpr int CHUNK_WORDS = 8;  // activation table rows pack_x holds at once: 256 bits
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

// The stream words of probability p against a table row: .x against its
// top sequence, .y against its bottom one (see the note at the top).  The
// thresholds of p's bucket are those of sorted positions [start, end); the
// ones below it are all < p, the ones above all > p, so c = start plus the
// bucket's thresholds < p, which are a prefix of them.
__device__ __forceinline__ uint2 stream_words(const uint32_t* row, float p) {
  const float* key = reinterpret_cast<const float*>(row);
  const uint32_t e = reinterpret_cast<const uint16_t*>(row + BUCKETS_AT)[bucket_of(p)];
  const int end = e >> 8;
  int c = e & 0xffu;
  while (c < end && key[c] < p) ++c;
  return reinterpret_cast<const uint2*>(row + MASKS_AT)[c];
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
// K4
// ---------------------------------------------------------------------------

// Activation streams: xbits[i, w] for the MP probabilities of x, against
// the activation rows (K, w) of the tables, staged in shared memory
// CHUNK_WORDS rows at a time (any stream length: a word depends only on
// its own row).
template <typename T>
__global__ void pack_x(const T* __restrict__ x, const uint32_t* __restrict__ tab, int K, int W,
                       uint32_t* __restrict__ xbits, size_t MP) {
  __shared__ __align__(16) uint32_t t[CHUNK_WORDS][ROW];
  for (int w0 = 0; w0 < W; w0 += CHUNK_WORDS) {
    const int nw = min(CHUNK_WORDS, W - w0);
    __syncthreads();  // the previous chunk's rows are consumed
    for (int i = threadIdx.x; i < nw * ROW; i += blockDim.x)
      t[i / ROW][i % ROW] = tab[table_row(K, w0 + i / ROW, K) + i % ROW];
    __syncthreads();
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < MP;
         i += (size_t)gridDim.x * blockDim.x) {
      const float p = repro_epi::load<T>(x, i);
      for (int w = 0; w < nw; ++w) xbits[i * W + w0 + w] = stream_words(t[w], p).x;
    }
  }
}

// OR-accumulated AND products, one word of the streams per pass.
//   SRC_PLANES: acc with the plane [wa; wb] (K half-ports, tables tab)
//   SRC_WORDS:  acc with pre-packed words wbits [K, N, W] (K ports)
// Blocks along z take k_split (half-)ports each and OR into acc with
// atomics when there is more than one.
template <int SRC, typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    contract(const uint32_t* __restrict__ xbits, const T* __restrict__ wa,
             const T* __restrict__ wb, const uint32_t* __restrict__ wbits,
             const uint32_t* __restrict__ tab, uint32_t* __restrict__ acc, int M, int N, int K,
             int W, int k_split, int use_atomic) {
  constexpr int TX = BN / TN;
  constexpr int NT = (BM / TM) * TX;
  constexpr bool HALVES = SRC == SRC_PLANES;
  constexpr int H = HALVES ? 2 : 1;  // ports k and k + K
  __shared__ uint32_t xs[H][BK][BM + 1];
  __shared__ __align__(16) uint32_t tb[HALVES ? BK : 1][ROW];
  __shared__ uint32_t ws[H][BK][BN];

  const int P = HALVES ? 2 * K : K;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_split;
  const int ke = min(K, kb + k_split);

  for (int w = 0; w < W; ++w) {
    uint32_t ap[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) ap[i][j] = 0u;

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
        for (int i = tid; i < BK * ROW / 4; i += NT) {
          const int kk = i / (ROW / 4), gk = k0 + kk;
          reinterpret_cast<uint4*>(&tb[0][0])[i] =
              gk < ke ? reinterpret_cast<const uint4*>(tab + table_row(gk, w, K))[i % (ROW / 4)]
                      : make_uint4(0u, 0u, 0u, 0u);
        }
      }
      __syncthreads();
      if constexpr (SRC == SRC_WORDS) {
        for (int i = tid; i < BK * BN; i += NT) {
          const int kk = i / BN, nn = i % BN;
          const int gk = k0 + kk, gn = n0 + nn;
          ws[0][kk][nn] = gk < ke && gn < N ? wbits[((size_t)gk * N + gn) * W + w] : 0u;
        }
      } else {
        // a thread builds the words of 8 adjacent columns of one row at once
        // (row_words); the top words of wa, port k, and the bottom words of
        // wb, port k + K
        constexpr int G = 8;
        static_assert(BN % G == 0 && (BK * BN / G) % NT == 0, "whole groups for every thread");
        for (int g = tid; g < BK * BN / G; g += NT) {
          const int kk = g / (BN / G), nn = g % (BN / G) * G;
          const int gk = k0 + kk;
          float v[2 * G];
#pragma unroll
          for (int c = 0; c < G; ++c) {
            const bool ok = gk < ke && n0 + nn + c < N;
            const size_t o = (size_t)gk * N + n0 + nn + c;
            v[c] = ok ? repro_epi::load<T>(wa, o) : 0.0f;
            v[G + c] = ok ? repro_epi::load<T>(wb, o) : 0.0f;
          }
          uint2 words[2 * G];
          row_words(tb[kk], v, words);
#pragma unroll
          for (int c = 0; c < G; ++c) {
            const bool ok = gk < ke && n0 + nn + c < N;
            ws[0][kk][nn + c] = ok ? words[c].x : 0u;
            ws[H - 1][kk][nn + c] = ok ? words[G + c].y : 0u;
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
        if (use_atomic)
          atomicOr(acc + o, ap[i][j]);
        else
          acc[o] = ap[i][j];
      }
    }
  }
}

template <int SRC, typename T, int BM, int BN, int BK, int TM, int TN>
void run_contract(const uint32_t* xbits, const void* wa, const void* wb, const uint32_t* wbits,
                  const uint32_t* tab, uint32_t* acc, int M, int N, int K, int W,
                  cudaStream_t st) {
  const int gx = (N + BN - 1) / BN, gy = (M + BM - 1) / BM;
  const int kblocks = (K + BK - 1) / BK;
  // split K until about two blocks per SM are in flight
  const int want = (2 * repro_epi::sm_count() + gx * gy - 1) / (gx * gy);
  const int parts = std::min(kblocks, std::max(1, want));
  const int k_split = ((kblocks + parts - 1) / parts) * BK;
  const int splits = (K + k_split - 1) / k_split;
  if (splits > 1) cudaMemsetAsync(acc, 0, (size_t)M * N * W * sizeof(uint32_t), st);
  contract<SRC, T, BM, BN, BK, TM, TN><<<dim3(gx, gy, splits), (BM / TM) * (BN / TN), 0, st>>>(
      xbits, static_cast<const T*>(wa), static_cast<const T*>(wb), wbits, tab, acc, M, N, K, W,
      k_split, splits > 1);
}

template <int SRC, typename T>
void contract_any(const uint32_t* xbits, const void* wa, const void* wb, const uint32_t* wbits,
                  const uint32_t* tab, uint32_t* acc, int M, int N, int K, int W,
                  cudaStream_t st) {
  if (M <= 4)
    run_contract<SRC, T, 4, 128, 16, 4, 1>(xbits, wa, wb, wbits, tab, acc, M, N, K, W, st);
  else
    run_contract<SRC, T, 64, 128, 16, 8, 4>(xbits, wa, wb, wbits, tab, acc, M, N, K, W, st);
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
// (sc_tables).  x, wa, wb: float32 or bfloat16 probabilities.  Scratch:
// xbits (M*2K*W words), acc (M*N*W), W = bits / 32.
extern "C" int sc_matmul(int in_bf16, const void* x, const void* wa, const void* wb,
                         const uint32_t* tab, uint32_t* xbits, uint32_t* acc, float* out, int M,
                         int N, int K, int bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = bits / 32;
  const size_t MP = (size_t)M * 2 * K;
  if (in_bf16) {
    pack_x<__nv_bfloat16><<<repro_epi::grid_for(MP, 256), 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), tab, K, W, xbits, MP);
    contract_any<SRC_PLANES, __nv_bfloat16>(xbits, wa, wb, nullptr, tab, acc, M, N, K, W, st);
  } else {
    pack_x<float><<<repro_epi::grid_for(MP, 256), 256, 0, st>>>(static_cast<const float*>(x),
                                                               tab, K, W, xbits, MP);
    contract_any<SRC_PLANES, float>(xbits, wa, wb, nullptr, tab, acc, M, N, K, W, st);
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
  contract_any<SRC_WORDS, float>(xbits, nullptr, nullptr, wbits, nullptr, acc, M, N, P, W, st);
  counts_to_value<<<repro_epi::grid_for((size_t)M * N, 256), 256, 0, st>>>(acc, W, (float)bits,
                                                                          out, (size_t)M * N);
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
                               const void* add, const float* coeffs, int P, float mean_scale,
                               float eps, void* out, int M, int N, int K, int bits,
                               void* stream) {
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
        mean_scale, eps, out, M, N, st);
  else
    repro_epi::finish<float>(PlaneDifference<float>{acc_p, acc_n, W, (float)bits, pre}, gain,
                             add, coeffs, P, mean_scale, eps, out, M, N, st);
  return (int)cudaGetLastError();
}

extern "C" const char* sc_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
