// Single-token decode attention with an online softmax: kernel K3.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py:flash_decode
// (_kernel).  q [B,KV,G,dh] attends to the caches [B,S,KV,dh] up to and
// including each row's own position pos[b]; the output is [B,KV,G,dh]
// float32.
//
// What bounds it on this card: bytes.  Each cache row up to pos is read
// once and used for G query heads (a few flops per byte), and at serving
// batch sizes the whole call is small enough that launch latency matters
// as much as bandwidth.
//
// What the design does about it:
// * One block per (kv head, batch row) serves up to GT query heads of the
//   group, GT * dh <= 2048 outputs (8 accumulator registers a thread), so
//   every key and value row is read from device memory once per GT heads.
//   A larger group (G * dh > 2048: granite-20b's 48 heads of one KV head,
//   dh 128, hold 6144) is split across a third grid dimension of G tiles,
//   each reading the group's rows again, mostly from L2.
// * The block walks only the keys 0..pos[b] in chunks of TS rows staged in
//   shared memory; keys past pos are never read (the reference's bucketed
//   block skip).  The ragged last chunk is masked with -1e30 like the
//   reference.
// * The running max m, normaliser l and the [G, dh] accumulator stay in
//   float32 (the accumulator in registers) across chunks, so only one
//   [G, TS] logit slab ever exists.  The result is allclose to the plain
//   softmax, not bitwise: the online softmax reassociates the sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "epilogue.cuh"

namespace {

constexpr int TS = 32;        // keys per chunk (one per lane in the softmax)
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_R = 8;      // accumulator registers a thread may hold
constexpr float NEG_INF = -1e30f;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                        const T* __restrict__ cv, const int* __restrict__ pos,
                        float* __restrict__ out, int S, int KV, int G_all, int GT, int dh,
                        float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [GT][dh]
  float* ks = qs + GT * dh;          // [TS][dh + 1] (padded: conflict-free dots)
  float* vs = ks + TS * (dh + 1);    // [TS][dh]
  float* ps = vs + TS * dh;          // [GT][TS] logits, then probabilities
  float* ms = ps + GT * TS;          // [GT] running max
  float* ls = ms + GT;               // [GT] running normaliser
  float* al = ls + GT;               // [GT] this chunk's rescale factor

  const int kv = blockIdx.x, b = blockIdx.y;
  const int g0 = blockIdx.z * GT;        // this block's query heads g0 .. g0 + G - 1
  const int G = min(GT, G_all - g0);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = min(pos[b], S - 1) + 1;  // keys 0..pos
  const int GD = G * dh;

  const size_t qbase = (((size_t)b * KV + kv) * G_all + g0) * dh;
  for (int i = tid; i < GD; i += THREADS) qs[i] = repro_epi::load<T>(q, qbase + i);
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = NEG_INF;
    ls[g] = 0.0f;
  }
  float acc[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) acc[r] = 0.0f;

  for (int s0 = 0; s0 < n; s0 += TS) {
    __syncthreads();  // previous chunk fully consumed (and q / m / l set)
    for (int i = tid; i < TS * dh; i += THREADS) {
      const int s = i / dh, d = i % dh;
      float kval = 0.0f, vval = 0.0f;
      if (s0 + s < n) {
        const size_t off = (((size_t)b * S + s0 + s) * KV + kv) * dh + d;
        kval = repro_epi::load<T>(ck, off);
        vval = repro_epi::load<T>(cv, off);
      }
      ks[s * (dh + 1) + d] = kval;
      vs[s * dh + d] = vval;
    }
    __syncthreads();
    for (int i = tid; i < G * TS; i += THREADS) {
      const int g = i / TS, s = i % TS;
      float logit = NEG_INF;
      if (s0 + s < n) {
        float dot = 0.0f;
        for (int d = 0; d < dh; ++d) dot += qs[g * dh + d] * ks[s * (dh + 1) + d];
        logit = dot * scale;
      }
      ps[i] = logit;
    }
    __syncthreads();
    for (int g = warp; g < G; g += THREADS / 32) {
      const float v = ps[g * TS + lane];
      float mx = v;
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(v - m_new);
      float sum = p;
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[g * TS + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        al[g] = alpha;
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      const int o = tid + r * THREADS;
      if (o < GD) {
        const int g = o / dh, d = o % dh;
        float pv = 0.0f;
        for (int s = 0; s < TS; ++s) pv += ps[g * TS + s] * vs[s * dh + d];
        acc[r] = acc[r] * al[g] + pv;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    const int o = tid + r * THREADS;
    if (o < GD) out[qbase + o] = acc[r] / ls[o / dh];
  }
}

template <typename T>
int launch(const void* q, const void* ck, const void* cv, const int* pos, float* out, int B,
           int S, int KV, int G, int dh, float scale, cudaStream_t st) {
  const int GT = std::min(G, THREADS * MAX_R / dh);  // query heads of a block
  const size_t bytes = sizeof(float) * ((size_t)GT * dh + (size_t)TS * (dh + 1) +
                                        (size_t)TS * dh + (size_t)GT * TS + 3 * (size_t)GT);
  cudaFuncSetAttribute(flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  flash_decode_kernel<T><<<dim3(KV, B, (G + GT - 1) / GT), THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv), pos, out,
      S, KV, G, GT, dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B,KV,G,dh], caches: [B,S,KV,dh] (float32 or bfloat16, contiguous),
// pos: [B] int32, out: [B,KV,G,dh] float32.  Needs dh <= 2048; a group of
// more than 2048 / dh query heads is split across blocks.
extern "C" int flash_decode(int in_bf16, const void* q, const void* ck, const void* cv,
                            const int* pos, float* out, int B, int S, int KV, int G, int dh,
                            float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh > THREADS * MAX_R) return (int)cudaErrorInvalidValue;
  if (in_bf16) return launch<__nv_bfloat16>(q, ck, cv, pos, out, B, S, KV, G, dh, scale, st);
  return launch<float>(q, ck, cv, pos, out, B, S, KV, G, dh, scale, st);
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
