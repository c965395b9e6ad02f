// Issue rate of the card's 32-bit integer multiplies, the ceiling of kernel
// B6's 64-bit multiply-accumulates (csrc/ntt_sharded.cu: four IMAD.WIDE.U32
// a MAC).  Each thread runs 8 independent chains of one kind of multiply
// over 4096 iterations, 8 CTAs of 256 threads a SM; prints the rate a clock
// a SM of IMAD.WIDE.U32 (32 x 32 -> 64 with a 64-bit addend), IMAD (32-bit)
// and IMAD.HI.U32, three launches each.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o int_mul_rate tools/int_mul_rate.cu
//   ./int_mul_rate
#include <cstdio>
#include <cuda_runtime.h>
typedef unsigned long long u64;
typedef unsigned int u32;
constexpr int kIters = 4096, kChains = 8;

__global__ void wide(u64* out, u32 a, u32 b) {
  u64 acc[kChains];
  for (int k = 0; k < kChains; ++k) acc[k] = threadIdx.x + k;
  u32 x = a + threadIdx.x, y = b;
  for (int i = 0; i < kIters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) acc[k] = static_cast<u64>(x + k) * y + acc[k];
    y += 1;
  }
  u64 s = 0;
  for (int k = 0; k < kChains; ++k) s ^= acc[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void lo32(u64* out, u32 a, u32 b) {
  u32 acc[kChains];
  for (int k = 0; k < kChains; ++k) acc[k] = threadIdx.x + k;
  u32 x = a + threadIdx.x, y = b;
  for (int i = 0; i < kIters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) acc[k] = (x + k) * y + acc[k];
    y += 1;
  }
  u32 s = 0;
  for (int k = 0; k < kChains; ++k) s ^= acc[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void hi32(u64* out, u32 a, u32 b) {
  u32 acc[kChains];
  for (int k = 0; k < kChains; ++k) acc[k] = threadIdx.x + k;
  u32 x = a + threadIdx.x, y = b;
  for (int i = 0; i < kIters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) acc[k] = __umulhi(x + acc[k], y);
    y += 1;
  }
  u32 s = 0;
  for (int k = 0; k < kChains; ++k) s ^= acc[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  int sms = 0, clk = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
  const int blocks = sms * 8, threads = 256;
  u64* out;
  cudaMalloc(&out, sizeof(u64) * blocks * threads);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const char* names[] = {"IMAD.WIDE.U32 (64-bit addend)", "IMAD (32-bit)", "IMAD.HI.U32"};
  void (*ks[])(u64*, u32, u32) = {wide, lo32, hi32};
  for (int k = 0; k < 3; ++k) {
    for (int rep = 0; rep < 3; ++rep) {
      ks[k]<<<blocks, threads>>>(out, 3, 5);
      cudaEventRecord(e0);
      ks[k]<<<blocks, threads>>>(out, 3, 5);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms = 0;
      cudaEventElapsedTime(&ms, e0, e1);
      const double ops = double(blocks) * threads * kIters * kChains;
      printf("%s: %.3f ms, %.1f G ops/s, %.2f a clock a SM at %d MHz\n", names[k], ms,
             ops / ms / 1e6, ops / (ms * 1e-3) / sms / (clk * 1e3), clk / 1000);
    }
  }
  printf("%s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
