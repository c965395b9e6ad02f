// The rungs below kernel B4 (matrix_fhe_tpu_torch/csrc/ntt64.cu), for
// tools/ntt_cluster_sweep.py --b4: what one transform costs before its
// butterflies.  Each rung has B4's launch geometry for a row of 2^LOGN
// 64-bit words over a cluster of C CTAs (threads, dynamic shared memory
// padded by a word every 16, cluster attribute, C = 16 non-portable; the
// row-major [rows, N] tensor, one row a cluster):
//   rung 0: an empty launch;
//   rung 1: the row's data movement alone.  Forward: each CTA reads the words
//           b + k N/C of its bases b (the cross pass's gather) and writes word
//           k into CTA k's shared memory, a cluster barrier, then it stores its
//           own chunk.  Inverse: each CTA loads its chunk, a cluster barrier,
//           then it reads the words of its bases from the C chunks and stores
//           them at b + k N/C, and a cluster barrier before exit.  No
//           arithmetic, no twiddles.
// The full kernel is the third rung.  Measurement only: the port never
// launches these.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#ifndef MFHE_NTT_LOGN
#error "build with -DMFHE_NTT_LOGN=<log2 N>"
#endif

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;

__host__ __device__ constexpr int log2i(int c) { return c <= 1 ? 0 : 1 + log2i(c / 2); }
__host__ __device__ constexpr uint32_t phys(uint32_t j) { return j + (j >> 4); }
__host__ __device__ constexpr int threads_for(int lognl) {
  return lognl - 3 <= 5 ? 32 : (lognl - 3 >= 8 ? 256 : 1 << (lognl - 3));
}

template <int LOGN, int C, int RUNG, bool FWD>
__global__ void __launch_bounds__(256, 1) ladder_kernel(const u64* __restrict__ in,
                                                        u64* __restrict__ out) {
  constexpr int LOGNL = LOGN - log2i(C);
  constexpr int NL = 1 << LOGNL;
  constexpr int T = threads_for(LOGNL);
  extern __shared__ u64 a[];
  if constexpr (RUNG == 0) {
    return;
  } else {
    const size_t row = blockIdx.x / C;
    uint32_t rank = 0;
    u64* part[C];
    for (int k = 0; k < C; ++k) part[k] = a;
    if constexpr (C > 1) {
      rank = cg::this_cluster().block_rank();
      for (int k = 0; k < C; ++k) part[k] = cg::this_cluster().map_shared_rank(a, k);
      cg::this_cluster().sync();
    }
    const u64* src = in + (row << LOGN);
    u64* dst = out + (row << LOGN);
    const uint32_t first = rank * (NL / C);
    if constexpr (FWD) {
      if constexpr (C > 1) {
        for (uint32_t b = first + threadIdx.x; b < first + NL / C; b += T) {
          u64 x[C];
#pragma unroll
          for (int k = 0; k < C; ++k) x[k] = __ldg(src + b + k * NL);
#pragma unroll
          for (int k = 0; k < C; ++k) part[k][phys(b)] = x[k];
        }
        cg::this_cluster().sync();
      } else {
        for (int j = threadIdx.x; j < NL; j += T) a[phys(j)] = __ldg(src + j);
        __syncthreads();
      }
      for (int j = threadIdx.x; j < NL; j += T) dst[rank * NL + j] = a[phys(j)];
    } else {
      for (int j = threadIdx.x; j < NL; j += T) a[phys(j)] = __ldg(src + rank * NL + j);
      if constexpr (C > 1) {
        cg::this_cluster().sync();
        for (uint32_t b = first + threadIdx.x; b < first + NL / C; b += T) {
          u64 x[C];
#pragma unroll
          for (int k = 0; k < C; ++k) x[k] = part[k][phys(b)];
#pragma unroll
          for (int k = 0; k < C; ++k) dst[b + k * NL] = x[k];
        }
        cg::this_cluster().sync();
      } else {
        __syncthreads();
        for (int j = threadIdx.x; j < NL; j += T) dst[j] = a[phys(j)];
      }
    }
  }
}

using Kernel = void (*)(const u64*, u64*);

template <int C>
constexpr bool built() {
  return MFHE_NTT_LOGN - log2i(C) <= 14 && (C == 1 || MFHE_NTT_LOGN >= 10);
}

template <int C, int RUNG, bool FWD>
Kernel kernel_for() {
  if constexpr (built<C>()) {
    return ladder_kernel<MFHE_NTT_LOGN, C, RUNG, FWD>;
  } else {
    return nullptr;
  }
}

template <int RUNG, bool FWD>
Kernel pick_c(int c) {
  switch (c) {
    case 1: return kernel_for<1, RUNG, FWD>();
    case 2: return kernel_for<2, RUNG, FWD>();
    case 4: return kernel_for<4, RUNG, FWD>();
    case 8: return kernel_for<8, RUNG, FWD>();
    case 16: return kernel_for<16, RUNG, FWD>();
    default: return nullptr;
  }
}

}  // namespace

// One launch of rung `rung` (0 or 1) in direction `fwd` over `rows` rows of
// 2^MFHE_NTT_LOGN words, each over `cluster` CTAs, on `stream`; returns the
// CUDA error (cudaErrorInvalidValue for a rung or cluster size not built).
extern "C" int mfhe_ntt64_ladder(int rung, int fwd, const void* in, void* out, int rows,
                                 int cluster, void* stream) {
  Kernel k = nullptr;
  if (rung == 0) k = fwd ? pick_c<0, true>(cluster) : pick_c<0, false>(cluster);
  if (rung == 1) k = fwd ? pick_c<1, true>(cluster) : pick_c<1, false>(cluster);
  if (k == nullptr || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int lognl = MFHE_NTT_LOGN - log2i(cluster);
  const size_t smem = sizeof(u64) * phys(1u << lognl);
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * cluster, 1, 1);
  cfg.blockDim = dim3(threads_for(lognl), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, k, static_cast<const u64*>(in), static_cast<u64*>(out));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
