// Single-token decode attention with an online softmax: kernel K3, with
// the key range split across the card's SMs (split-KV, "flash-decoding").
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py:flash_decode
// (_kernel).  q [B,KV,G,dh] attends to the caches [B,S,KV,dh] at keys
// 0..min(pos[b], S-1); the output is [B,KV,G,dh] float32.
//
// What bounds it on this card: bytes and latency, not arithmetic.  Each
// key and value row up to pos is read once and used for a tile of G query
// heads: at G 8 about 8 operations a byte, far below the ~295 a byte at
// which the tensor cores would set the pace.  At B 4, S 4096 the float32
// work is about 134 MFLOP (2 us at 67 TFLOP/s) against 4.9 us of bytes; at
// the serving window (S 96) a call is one dependent trip to device memory
// and the combine.
//
// What the design does about it:
// * The Pallas kernel walks S as a sequential grid axis and carries
//   (m, l, acc) in scratch from one step to the next; a TPU core runs the
//   grid in order.  Here the key range of a (batch row, KV head, G tile)
//   is split across blocks, a split of split_len keys each, so that the
//   blocks fill the card at long S: 24 blocks at the serving shape (B 4,
//   S 96, KV 2, G 8, dh 128; the parent's one block a row walked all keys
//   on 8 SMs), 256 at B 4, S 4096.  The geometry (heads a tile, lanes a
//   row, split length) is chosen in Python (repro_torch/kernels/
//   flash_decode.py:geometry) and passed in; this file checks it.
// * pos is on the device: a block whose split starts past pos[b] exits at
//   once (the reference's bucketed skip).  Split 0 always runs, so a row
//   with no key gives 0/0 as the reference's kernel does.  q is loaded
//   while pos is on its way.
// * Inside a block, each of 4 warps owns key tiles: lanes cover a row of
//   dh with 16-byte loads (8 bf16 or 4 float32 values; a bf16 row of 128
//   takes 16 lanes, so a warp takes two keys a step), and each lane keeps
//   its slice of q for the tile's heads in registers, pre-scaled by
//   dh^-0.5 log2(e) so that the softmax runs in exp2.  A tile's 4 steps
//   are computed together (their chains are independent), and each key's
//   per-head dot products are reduce-scattered over the row's lanes (every
//   round keeps half the heads), so a lane ends with one head's logit: 8
//   shuffles a key where a full reduction of each of 8 heads takes 32, and
//   one exp2 a lane where it takes 8.  The shuffle pipe (one warp
//   instruction a clock an SM) set the pace of the full reduction.
// * The running max is per head, shared by the warp's rows, updated once a
//   tile; the accumulator is rescaled only when a max grows (exactly: the
//   factor is 1 for the other heads).  P.V accumulates in float32
//   registers, each lane taking the tile's probabilities by shuffles.
// * Each warp streams its tiles through its own ring of 3 stages in
//   shared memory, filled by 16-byte cp.async copies two tiles ahead; a
//   lane reads back only what it copied itself, so the ring needs no
//   barrier (cp.async.wait_group is enough).  Keys past the split's end are
//   zero-filled and masked.
// * The splits are combined in the same launch.  A block merges its warps
//   in warp order; if the row has one live split it writes the output,
//   else it writes its (m, l, acc) to a float32 scratch and counts itself
//   on the row's counter with a gpu-scope acq_rel atomic (after a block
//   barrier: the release covers every thread's stores, as CUTLASS's
//   semaphore does; two __threadfence() cost more).  The last block of the
//   row to count merges every live split in split order, 8 partials to a
//   trip to memory, and resets the counter to 0 for the next call.  So the
//   result is the same, bit for bit, from run to run, and one launch does
//   it all.  The counters are kept by the wrapper between calls; two calls
//   sharing them must not run at once (the port launches K3 on one
//   stream).
// * Float32 arithmetic throughout, no tensor cores: P rounded to bf16 for
//   an mma would break the 1e-4 contract with the plain version, and the
//   arithmetic is not what bounds the kernel (above).
// * A group with G above a tile (8 heads at dh <= 256 in bf16: the
//   registers a lane holds, and no more heads than a row has lanes) is
//   split across G tiles, each reading the group's rows again, mostly from
//   L2 (granite-20b: 48 heads of dh 128, 6 tiles).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace repro_flash_decode {

constexpr int WARPS = 4;  // warps a block
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 3;  // tiles in a warp's ring
constexpr int MERGE_V = 2;  // float4 of the outputs a thread merges at once
constexpr int MERGE_CHUNK = 8;  // partials of other blocks a thread loads at once
constexpr int MAX_DEVICES = 64;
// dynamic shared memory a block may take on sm_90 (227 KB), less room for the
// kernel's static shared memory
constexpr int MAX_SMEM = 232448 - 1024;
constexpr float NEG = -1e30f;  // the reference's NEG_INF, in the log2 domain too
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* ck;
  const void* cv;
  const int* pos;
  float* out;
  float* part;  // [rows][n_splits][pstride]: each split's acc [gt][dh], m [gt], l [gt]
  int* count;   // [rows], 0 between calls
  int S, KV, G, dh, gt, n_gt, lpr, split_len, n_splits;
  float scale2;  // dh^-0.5 * log2(e)
};

// warp steps a tile: 4 chunks of K (and of V) a lane
__host__ __device__ constexpr int steps_of(int nv) { return nv >= 4 ? 1 : 4 / nv; }

// 16 bytes of T as floats
template <typename T>
__device__ __forceinline__ void to_float(const uint4& u, float* f);
template <>
__device__ __forceinline__ void to_float<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void to_float<__nv_bfloat16>(const uint4& u, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // element 2i is the low half of word i
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
// a gpu-scope acq_rel add: the block's earlier stores (ordered before by
// __syncthreads) are visible to the block that sees the count it leaves,
// and that block's later loads see every counted block's stores
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// loads of the partials: those in device memory were written by other
// blocks, so they are read past L1
template <bool GLOBAL>
__device__ __forceinline__ float ld(const float* p) {
  if constexpr (GLOBAL) return __ldcg(p);
  return *p;
}
template <bool GLOBAL>
__device__ __forceinline__ float4 ld4(const float4* p) {
  if constexpr (GLOBAL) return __ldcg(p);
  return *p;
}

// Merge `count` partials (acc [gt][dh], m [gt], l [gt], `pstride` floats
// apart, a multiple of 4) in their order, CHUNK at a time: each chunk
// is one trip to memory (every load of it in flight together), then folded
// into a running max, normaliser and sum.  Into `dst` as one partial of the
// same layout, or, with dst null, into the output rows out [gn][dh] as
// acc / l.  A thread takes MERGE_V float4 of the outputs.
template <bool GLOBAL, int CHUNK>
__device__ void merge(const float* parts, int count, int pstride, int gt, int gn, int dh,
                      float* dst, float* out) {
  const int n4 = gn * dh / 4;  // float4 of the outputs (dh is a multiple of 4)
  const float* ml = parts + gt * dh;  // each partial's m, then l
  for (int o0 = threadIdx.x; o0 < n4; o0 += MERGE_V * THREADS) {
    int o[MERGE_V], g[MERGE_V];
    float mx[MERGE_V], l[MERGE_V];
    float4 acc[MERGE_V];
#pragma unroll
    for (int k = 0; k < MERGE_V; ++k) {
      o[k] = min(o0 + k * THREADS, n4 - 1);
      g[k] = 4 * o[k] / dh;
      mx[k] = NEG;
      l[k] = 0.0f;
      acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    for (int c0 = 0; c0 < count; c0 += CHUNK) {
      float mi[CHUNK][MERGE_V], li[CHUNK][MERGE_V];
      float4 ai[CHUNK][MERGE_V];
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) {
        const bool here = c0 + i < count;  // past the end: an empty partial
        const int at = (here ? c0 + i : 0) * pstride;
#pragma unroll
        for (int k = 0; k < MERGE_V; ++k) {
          mi[i][k] = here ? ld<GLOBAL>(ml + at + g[k]) : NEG;
          li[i][k] = here ? ld<GLOBAL>(ml + at + gt + g[k]) : 0.0f;
          ai[i][k] = here ? ld4<GLOBAL>(reinterpret_cast<const float4*>(parts + at) + o[k])
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int k = 0; k < MERGE_V; ++k) {
        float cm = mx[k];
#pragma unroll
        for (int i = 0; i < CHUNK; ++i) cm = fmaxf(cm, mi[i][k]);
        const float r = exp2f(mx[k] - cm);
        mx[k] = cm;
        l[k] *= r;
        acc[k].x *= r;
        acc[k].y *= r;
        acc[k].z *= r;
        acc[k].w *= r;
#pragma unroll
        for (int i = 0; i < CHUNK; ++i) {  // in order: the same sums every run
          const float w = exp2f(mi[i][k] - cm);
          l[k] = fmaf(w, li[i][k], l[k]);
          acc[k].x = fmaf(w, ai[i][k].x, acc[k].x);
          acc[k].y = fmaf(w, ai[i][k].y, acc[k].y);
          acc[k].z = fmaf(w, ai[i][k].z, acc[k].z);
          acc[k].w = fmaf(w, ai[i][k].w, acc[k].w);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < MERGE_V; ++k) {
      if (o0 + k * THREADS >= n4) continue;
      if (dst == nullptr) {
        reinterpret_cast<float4*>(out)[o[k]] =
            make_float4(acc[k].x / l[k], acc[k].y / l[k], acc[k].z / l[k], acc[k].w / l[k]);
      } else {
        reinterpret_cast<float4*>(dst)[o[k]] = acc[k];
        if (4 * o[k] == g[k] * dh) {
          dst[gt * dh + g[k]] = mx[k];
          dst[gt * dh + gt + g[k]] = l[k];
        }
      }
    }
  }
}

// One block: split blockIdx.x of the keys of batch row blockIdx.z, KV head
// and G tile blockIdx.y.  NV 16-byte chunks of a row a lane, at most MAXG
// query heads a tile; a warp tile is STEPS steps of 32 / lpr keys.
template <typename T, int NV, int MAXG>
__global__ void __launch_bounds__(THREADS) flash_decode_split(const Args a) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int R = NV * VEC;  // floats of a row a lane holds
  constexpr int STEPS = steps_of(NV);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;

  const int split = blockIdx.x, b = blockIdx.z;
  const int kv = blockIdx.y / a.n_gt, gtile = blockIdx.y - kv * a.n_gt;
  const int row = (b * a.KV + kv) * a.n_gt + gtile;
  const int g0 = gtile * a.gt, gn = min(a.gt, a.G - g0);
  const int dh = a.dh, nvec = dh / VEC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lpr = a.lpr, rpw = 32 / lpr, rg = lane / lpr, sub = lane - rg * lpr;

  // this lane's slice of q for each head of the tile, in the log2 domain
  // (loaded while pos is on its way)
  const size_t head0 = ((size_t)b * a.KV + kv) * a.G + g0;
  const T* qb = static_cast<const T*>(a.q) + head0 * dh;
  float qr[MAXG][R];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int vi = sub + c * lpr;
      if (g < gn && vi < nvec) {
        to_float<T>(__ldg(reinterpret_cast<const uint4*>(qb + (size_t)g * dh + vi * VEC)),
                    &qr[g][c * VEC]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qr[g][c * VEC + e] = 0.0f;
      }
    }
  }
  const int n = min(__ldg(a.pos + b), a.S - 1) + 1;  // keys 0..n-1
  const int start = split * a.split_len;
  if (split > 0 && start >= n) return;  // wholly past pos
  const int end = min(start + a.split_len, n);
  const int n_live = max(1, (n + a.split_len - 1) / a.split_len);
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
#pragma unroll
    for (int e = 0; e < R; ++e) qr[g][e] *= a.scale2;
  }

  // after the reduce-scatter of a key's dot products, each lane holds the
  // logit of head hl (span lanes a head in each row); m and l are head hl's
  const int span = lpr / MAXG, hl = sub / span;
  float m = NEG, l = 0.0f, acc[MAXG][R];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
#pragma unroll
    for (int e = 0; e < R; ++e) acc[g][e] = 0.0f;
  }

  // the warp's tiles: t = warp, warp + WARPS, ... of tk keys from start
  const int tk = rpw * STEPS;
  const int n_tiles = end > start ? (end - start + tk - 1) / tk : 0;
  const int mine = n_tiles > warp ? (n_tiles - warp + WARPS - 1) / WARPS : 0;
  constexpr int STAGE = STEPS * NV * 64;  // uint4 a stage: K then V of each (step, chunk)
  uint4* ring = reinterpret_cast<uint4*>(smem) + warp * STAGES * STAGE;
  const size_t key_stride = (size_t)a.KV * dh;
  const size_t base = ((size_t)b * a.S * a.KV + kv) * dh;
  const T* kb = static_cast<const T*>(a.ck) + base;
  const T* vb = static_cast<const T*>(a.cv) + base;

  auto load_tile = [&](int i) {  // the warp's i-th tile into stage i % STAGES
    if (i < mine) {
      const int key0 = start + (warp + i * WARPS) * tk;
      uint4* st = ring + (i % STAGES) * STAGE;
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        const int key = key0 + j * rpw + rg;
        const bool ok = key < end;
        const size_t off = (size_t)(ok ? key : start) * key_stride;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const int vi = sub + c * lpr;
          const size_t at = off + (size_t)(vi < nvec ? vi : 0) * VEC;
          cp_async16(st + (j * NV + c) * 64 + lane, kb + at, ok && vi < nvec);
          cp_async16(st + (j * NV + c) * 64 + 32 + lane, vb + at, ok && vi < nvec);
        }
      }
    }
    cp_async_commit();  // empty groups too: the wait count stays uniform
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load_tile(i);
  for (int i = 0; i < mine; ++i) {
    load_tile(i + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    const uint4* st = ring + (i % STAGES) * STAGE;
    const int left = end - (start + (warp + i * WARPS) * tk);  // keys of the tile that exist
    // the tile's logits first (its steps are independent): each lane's dot
    // products for every head, then a reduce-scatter over the row's lanes,
    // halving the heads a lane keeps each round, and plain rounds after
    float s[STEPS];
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      float kf[R], d[MAXG];
#pragma unroll
      for (int c = 0; c < NV; ++c) to_float<T>(st[(j * NV + c) * 64 + lane], &kf[c * VEC]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        d[g] = 0.0f;
#pragma unroll
        for (int e = 0; e < R; ++e) d[g] = fmaf(qr[g][e], kf[e], d[g]);
      }
#pragma unroll
      for (int r = 0; (MAXG >> r) > 1; ++r) {
        const int half = (MAXG >> r) / 2, o = lpr >> (r + 1);
        const bool upper = sub & o;  // keeps the upper half of the heads
#pragma unroll
        for (int k = 0; k < half; ++k) {
          const float send = upper ? d[k] : d[k + half];
          const float keep = upper ? d[k + half] : d[k];
          d[k] = keep + __shfl_xor_sync(FULL, send, o);
        }
      }
      for (int o = span >> 1; o > 0; o >>= 1) d[0] += __shfl_xor_sync(FULL, d[0], o);
      // keys past the end (zero-filled) are masked
      s[j] = j * rpw + rg < left ? d[0] : NEG;
    }
    // every lane of head hl holds the same logits, bit for bit: a + b = b + a
    float mt = NEG;
#pragma unroll
    for (int j = 0; j < STEPS; ++j) mt = fmaxf(mt, s[j]);
    for (int o = lpr; o < 32; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, o));
    if (__any_sync(FULL, mt > m)) {  // a max grew: rescale (by 1 where it did not)
      const float mn = fmaxf(m, mt);
      const float al = exp2f(m - mn);
      m = mn;
      l *= al;
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        const float ag = __shfl_sync(FULL, al, g * span);
#pragma unroll
        for (int e = 0; e < R; ++e) acc[g][e] *= ag;
      }
    }
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      float vf[R];
#pragma unroll
      for (int c = 0; c < NV; ++c) to_float<T>(st[(j * NV + c) * 64 + 32 + lane], &vf[c * VEC]);
      const float p = exp2f(s[j] - m);
      l += p;
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        const float pg = __shfl_sync(FULL, p, rg * lpr + g * span);
#pragma unroll
        for (int e = 0; e < R; ++e) acc[g][e] = fmaf(pg, vf[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();

  // the warp's rows share m: add their l and acc
  for (int o = lpr; o < 32; o <<= 1) {
    l += __shfl_xor_sync(FULL, l, o);
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
#pragma unroll
      for (int e = 0; e < R; ++e) acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], o);
    }
  }
  __syncthreads();  // every ring drained: the warps' partials take its place
  const int pstride = (a.gt * dh + 2 * a.gt + 3) & ~3;  // 16-byte aligned partials
  float* wpart = reinterpret_cast<float*>(smem) + warp * pstride;
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int vi = sub + c * lpr;
        if (g < gn && vi < nvec) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) wpart[g * dh + vi * VEC + e] = acc[g][c * VEC + e];
        }
      }
    }
    if (sub == hl * span && hl < gn) {
      wpart[a.gt * dh + hl] = m;
      wpart[a.gt * dh + a.gt + hl] = l;
    }
  }
  __syncthreads();
  const float* warps = reinterpret_cast<const float*>(smem);
  float* out = a.out + head0 * dh;
  if (n_live == 1) {  // the only split of its row: the output directly
    merge<false, WARPS>(warps, WARPS, pstride, a.gt, gn, dh, nullptr, out);
    return;
  }
  float* parts = a.part + (size_t)row * a.n_splits * pstride;
  merge<false, WARPS>(warps, WARPS, pstride, a.gt, gn, dh, parts + (size_t)split * pstride,
                      nullptr);
  __syncthreads();  // every thread's stores of the partial precede the count
  if (tid == 0) {
    last = atomic_add_acq_rel(a.count + row, 1) == n_live - 1;
    if (last) a.count[row] = 0;  // every live split has counted: reset for the next call
  }
  __syncthreads();  // the count's acquire precedes every thread's loads
  if (last) merge<true, MERGE_CHUNK>(parts, n_live, pstride, a.gt, gn, dh, nullptr, out);
}

// Dynamic shared memory of a launch: the warps' rings, or their partials.
template <int NV>
size_t smem_bytes(const Args& a) {
  const size_t ring = (size_t)WARPS * STAGES * steps_of(NV) * NV * 64 * 16;
  const size_t pstride = ((size_t)a.gt * a.dh + 2 * a.gt + 3) & ~(size_t)3;
  return std::max(ring, 4 * WARPS * pstride);
}

template <typename T, int NV, int MAXG>
int launch(const Args& a, int B, cudaStream_t st) {
  static bool configured[MAX_DEVICES] = {};
  auto kernel = flash_decode_split<T, NV, MAXG>;
  const size_t bytes = smem_bytes<NV>(a);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {  // once per kernel instance and device
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  kernel<<<dim3(a.n_splits, a.KV * a.n_gt, B), THREADS, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int B, int nv, int maxg, cudaStream_t st) {
#define REPRO_FD_CASE(NV, MAXG) \
  if (nv == NV && maxg == MAXG) return launch<T, NV, MAXG>(a, B, st);
  REPRO_FD_CASE(1, 1)
  REPRO_FD_CASE(1, 2)
  REPRO_FD_CASE(1, 4)
  REPRO_FD_CASE(1, 8)
  REPRO_FD_CASE(2, 4)
  REPRO_FD_CASE(4, 2)
  REPRO_FD_CASE(8, 1)
  if constexpr (sizeof(T) == 4) REPRO_FD_CASE(16, 1)
#undef REPRO_FD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_flash_decode

// q: [B,KV,G,dh], caches: [B,S,KV,dh] (float32 or bfloat16, contiguous,
// 16-byte aligned), pos: [B] int32, out: [B,KV,G,dh] float32.  The
// geometry (flash_decode.py:geometry): gt query heads a G tile (at most
// maxg), lpr lanes a row of nv 16-byte chunks a lane, steps warp steps a
// tile, n_splits splits of split_len keys.  part: float32 scratch of
// B*KV*ceil(G/gt) rows x n_splits x (gt*dh + 2*gt) (unused with one
// split); count: int32 [B*KV*ceil(G/gt)], all 0, left 0.
extern "C" int flash_decode(int in_bf16, const void* q, const void* ck, const void* cv,
                            const int* pos, float* out, float* part, int* count, int B, int S,
                            int KV, int G, int dh, int gt, int maxg, int lpr, int nv, int steps,
                            int split_len, int n_splits, float scale, void* stream) {
  using namespace repro_flash_decode;
  const int vec = in_bf16 ? 8 : 4;
  const int nvec = dh > 0 ? dh / vec : 0;
  const bool pow2 = lpr > 0 && lpr <= 32 && (lpr & (lpr - 1)) == 0;
  if (B < 1 || S < 1 || KV < 1 || G < 1 || dh < vec || dh % vec != 0 || !pow2 || nv < 1 ||
      nvec > lpr * nv || (nv > 1 && lpr != 32) || gt < 1 || gt > maxg || maxg > lpr ||
      steps != steps_of(nv) || split_len < 1 || n_splits < 1 ||
      (long long)split_len * n_splits < S || (long long)split_len * (n_splits - 1) >= S ||
      (n_splits > 1 && (!part || !count)))
    return (int)cudaErrorInvalidValue;
  Args a{q, ck, cv, pos, out, part, count, S, KV, G, dh, gt, (G + gt - 1) / gt,
         lpr, split_len, n_splits, scale * 1.4426950408889634f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16) return dispatch<__nv_bfloat16>(a, B, nv, maxg, st);
  return dispatch<float>(a, B, nv, maxg, st);
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
