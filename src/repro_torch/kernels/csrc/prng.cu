// The generator sequences of one SC projection on Hopper, bitwise those of
// jax.random (threefry2x32, partitionable layout), the Gaussian noise of
// one INJECT-mode projection, and the stochastic rounding of AdamW's
// compressed first moment.
//
// Replaces the stream generation in front of the Pallas TPU kernels,
// repro/kernels/ops.py::sc_matmul (jax.random.uniform, not a Pallas
// kernel):
//   ux = uniform(kx, (1, bits)), uw = uniform(kw, (2K, bits)),
//   (kx, kw) = split(key), key = fold_in(...fold_in(PRNGKey(seed), d1)..., dn)
// -> sc_draws(), one launch per key path.
//
// What is computed (the plain version, repro_torch/kernels/prng.py, says
// it in PyTorch): element i of a draw is the threefry2x32 block of its key
// on the counter (i >> 32, i mod 2^32); of the two output words b0 ^ b1
// keeps its top 23 bits as the mantissa of a float in [1, 2), minus 1 (an
// exact subtraction).  PRNGKey(seed) is (0, seed mod 2^32), fold_in(key,
// d) the block of key on (0, d), split(key)[j] the block on (0, j).
//
// Replaces, for INJECT mode, repro/core/calibration.py::sample_error's
//   noise = jax.random.normal(key, y.shape, float32)
// -> normals(), one launch per projection: the same bits mapped to u in
// (-1, 1) as max(lo, f * 2 + lo), lo the float after -1, and sqrt(2) *
// erfinv(u) with XLA's float32 erfinv polynomial (w = -log1p(-u*u), the
// coefficient set for w < 5 or not), its steps fused multiply-adds as XLA
// contracts them, each taken in float64 (exact product) and rounded once:
// bitwise the plain version on the card, within 3 float32 ulps of
// jax.random.normal on the CPU (whose log1p is XLA's own).
//
// Replaces, for AdamW's compressed state, repro/optim/adamw.py::
// _stochastic_round_bf16's
//   noise = jax.random.randint(key, shape, 0, 1 << 16, uint32)
//   bf16((bits(x) + noise) & 0xFFFF0000)
// -> round_bf16(), one launch per tensor: randint over a span of 2^16 is
// the low 16 bits of the draw of split(key)[1] (the multiplier of the
// other stream is 2^32 mod 2^16 = 0), so element i adds (b0 ^ b1) & 0xFFFF
// of that key's block on counter offset + i to the float's bit pattern
// (a uint32 add that wraps) and keeps the top half, which is the bf16 of
// the masked float (exact; a NaN keeps its payload's top bits).  offset
// places a tensor inside the stacked [L, ...] leaf whose draws it takes.
//
// The key path comes as a few int32 words in device memory, not as
// launch arguments: every thread derives the key itself (one block per
// folded word, and one for each half of the split it needs), so a
// captured graph can change the path in place between replays.  The work
// is elementwise and bound by the 20 rounds of integer adds, rotates and
// xors of each block; a thread takes PER_THREAD elements, so the key's
// blocks are paid once per 8 elements: for a decode site's path (4 blocks
// of key) 2.9 and 5.7 us at 4096 x 32 and 22016 x 32 draws, against 3.0
// and 11.3 us with one element a thread (H100 80GB HBM3, 700 W,
// tools/time_kernel.py --kernel prng).
#include <cuda_runtime.h>
#include <stdint.h>

// Named so a profiler trace attributes the kernel to this file.
namespace repro_prng {
namespace {

struct Key {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) { return __funnelshift_l(v, v, r); }

// The 20-round threefry2x32 block of key k on the counter (x0, x1).
__device__ __forceinline__ Key threefry(Key k, uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k.a, k.b, k.a ^ k.b ^ 0x1BD11BDAu};
  constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return Key{x0, x1};
}

__device__ __forceinline__ float uniform_at(Key k, uint64_t i) {
  const Key r = threefry(k, (uint32_t)(i >> 32), (uint32_t)i);
  return __uint_as_float(((r.a ^ r.b) >> 9) | 0x3F800000u) - 1.0f;
}

// XLA's ErfInv32 coefficients, w < 5 and w >= 5 (kernels/prng.py)
__constant__ float kErfInvLt5[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
                                    -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
                                    -0.00417768164f,  0.246640727f,    1.50140941f};
__constant__ float kErfInvGe5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                                    -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                                    0.00943887047f,   1.00167406f,     2.83297682f};
constexpr float kNormalLo = -0.99999994f;  // nextafter(-1, 0)
constexpr float kSqrt2 = 1.41421354f;

__device__ __forceinline__ float erfinv_xla(float x) {
  float w = -log1pf(-__fmul_rn(x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  const double wd = (double)w;
  float p = lt ? kErfInvLt5[0] : kErfInvGe5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    const double c = (double)(lt ? kErfInvLt5[i] : kErfInvGe5[i]);
    p = __double2float_rn(__dadd_rn(c, __dmul_rn((double)p, wd)));
  }
  return fabsf(x) == 1.0f ? x * __int_as_float(0x7F800000) : __fmul_rn(p, x);
}

constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;

// Element i of the draws, i < bits: ux[i]; else uw[i - bits].  A block
// takes THREADS * PER_THREAD consecutive elements, a thread every
// THREADS-th of them (coalesced stores).
__global__ void __launch_bounds__(THREADS)
    draws(const int32_t* __restrict__ path, int n_path, float* __restrict__ ux,
          float* __restrict__ uw, int bits, long long n_w) {
  const long long first = blockIdx.x * (long long)(THREADS * PER_THREAD) + threadIdx.x;
  const long long n = bits + n_w;
  if (first >= n) return;
  Key k{0u, (uint32_t)path[0]};
  for (int j = 1; j < n_path; ++j) k = threefry(k, 0u, (uint32_t)path[j]);
  const long long last = min(n - 1, first + (long long)(PER_THREAD - 1) * THREADS);
  const Key kx = first < bits ? threefry(k, 0u, 0u) : Key{0u, 0u};
  const Key kw = last >= bits ? threefry(k, 0u, 1u) : Key{0u, 0u};
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const long long i = first + (long long)e * THREADS;
    if (i >= n) break;
    if (i < bits)
      ux[i] = uniform_at(kx, (uint64_t)i);
    else
      uw[i - bits] = uniform_at(kw, (uint64_t)(i - bits));
  }
}

// Element i of n normals: a block takes THREADS * PER_THREAD consecutive
// elements, a thread every THREADS-th of them.
__global__ void __launch_bounds__(THREADS)
    normals(const int32_t* __restrict__ path, int n_path, float* __restrict__ out, long long n) {
  const long long first = blockIdx.x * (long long)(THREADS * PER_THREAD) + threadIdx.x;
  if (first >= n) return;
  Key k{0u, (uint32_t)path[0]};
  for (int j = 1; j < n_path; ++j) k = threefry(k, 0u, (uint32_t)path[j]);
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const long long i = first + (long long)e * THREADS;
    if (i >= n) break;
    const float f = uniform_at(k, (uint64_t)i);
    const float u = fmaxf(kNormalLo, __fadd_rn(__fmul_rn(f, 2.0f), kNormalLo));
    out[i] = __fmul_rn(kSqrt2, erfinv_xla(u));
  }
}

// x [n] float32 -> out [n] bf16 bit patterns, stochastically rounded with
// the draws of the key path at counters offset .. offset + n - 1.  A block
// takes THREADS * ROUND_PER_THREAD consecutive elements, a thread every
// THREADS-th of them: the key's blocks (three for AdamW's path) are paid
// once per 32 elements, against the 32 blocks of the draws themselves.
constexpr int ROUND_PER_THREAD = 32;

__global__ void __launch_bounds__(THREADS)
    round_bf16(const int32_t* __restrict__ path, int n_path, const float* __restrict__ x,
               uint16_t* __restrict__ out, long long n, long long offset) {
  const long long first = blockIdx.x * (long long)(THREADS * ROUND_PER_THREAD) + threadIdx.x;
  if (first >= n) return;
  Key k{0u, (uint32_t)path[0]};
  for (int j = 1; j < n_path; ++j) k = threefry(k, 0u, (uint32_t)path[j]);
  const long long end = min(n, first + (long long)ROUND_PER_THREAD * THREADS);
  uint64_t c = (uint64_t)(offset + first);
#pragma unroll 4
  for (long long i = first; i < end; i += THREADS, c += THREADS) {
    const Key r = threefry(k, (uint32_t)(c >> 32), (uint32_t)c);
    const uint32_t u = __float_as_uint(x[i]) + ((r.a ^ r.b) & 0xFFFFu);
    out[i] = (uint16_t)(u >> 16);
  }
}

}  // namespace
}  // namespace repro_prng

using namespace repro_prng;

// ux [1, bits] and uw [ports, bits], float32 in [0, 1), the draws of the
// key path path[0 .. n_path) (seed mod 2^32, then the folded uint32s).
extern "C" int sc_draws(const int32_t* path, int n_path, float* ux, float* uw, int ports,
                        int bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_w = (long long)ports * bits, n = bits + n_w;
  if (n == 0) return 0;
  constexpr long long per_block = THREADS * PER_THREAD;
  draws<<<(unsigned)((n + per_block - 1) / per_block), THREADS, 0, st>>>(path, n_path, ux, uw,
                                                                          bits, n_w);
  return (int)cudaGetLastError();
}

// out [n], float32 standard normals of the key path path[0 .. n_path).
extern "C" int normal_draws(const int32_t* path, int n_path, float* out, long long n,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  constexpr long long per_block = THREADS * PER_THREAD;
  normals<<<(unsigned)((n + per_block - 1) / per_block), THREADS, 0, st>>>(path, n_path, out, n);
  return (int)cudaGetLastError();
}

// out [n] bf16 (as uint16 bit patterns): x [n] float32 stochastically
// rounded with the draws of the key path path[0 .. n_path) at counters
// offset .. offset + n - 1.
extern "C" int sr_bf16(const int32_t* path, int n_path, const float* x, uint16_t* out,
                       long long n, long long offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  constexpr long long per_block = THREADS * ROUND_PER_THREAD;
  round_bf16<<<(unsigned)((n + per_block - 1) / per_block), THREADS, 0, st>>>(path, n_path, x,
                                                                              out, n, offset);
  return (int)cudaGetLastError();
}

extern "C" const char* prng_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
