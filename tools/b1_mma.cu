// Throughput of the binary tensor-core product and of LOP3 on the ALU pipe,
// for tools/bench_b1_mma.py.
//
// b1_mma: every warp issues `iters` rounds of CHAINS independent
//   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc
// (16 x 8 x 256 AND+POPC bit products each) on register operands.
// lop3_loop: every thread issues `iters` rounds of CHAINS independent
//   lop3.b32 acc = (a & b) | acc
// (32 bit-ANDs and ORs each), the instruction the SC contractions run.
// Both write their accumulators out so that nothing is dropped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHAINS = 8;

__global__ void b1_mma_kernel(int iters, uint32_t seed, int* __restrict__ out) {
  const uint32_t t = threadIdx.x + blockIdx.x * blockDim.x;
  const uint32_t a0 = seed * 0x9E3779B9u + t, a1 = a0 * 3u, a2 = a0 ^ 0x55555555u, a3 = ~a0;
  const uint32_t b0 = a0 * 7u + 1u, b1 = b0 ^ 0x33333333u;
  int c[CHAINS][4];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = j;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[t] = s;
}

__global__ void lop3_kernel(int iters, uint32_t seed, int* __restrict__ out) {
  const uint32_t t = threadIdx.x + blockIdx.x * blockDim.x;
  const uint32_t a = seed * 0x9E3779B9u + t, b = a * 7u + 1u;
  uint32_t acc[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) acc[j] = a >> j;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j)
      asm volatile("lop3.b32 %0, %1, %2, %0, 0xEA;\n" : "+r"(acc[j]) : "r"(a), "r"(b + j));
  }
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s ^= acc[j];
  out[t] = (int)s;
}

}  // namespace

extern "C" int b1_chains() { return CHAINS; }

extern "C" int b1_mma(int blocks, int threads, int iters, int* out, void* stream) {
  b1_mma_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(iters, 1u, out);
  return (int)cudaGetLastError();
}

extern "C" int lop3_loop(int blocks, int threads, int iters, int* out, void* stream) {
  lop3_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(iters, 1u, out);
  return (int)cudaGetLastError();
}
