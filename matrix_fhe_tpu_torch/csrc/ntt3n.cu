// The factorized NTT of the 3N ring Z_q[X]/(X^N - X^{N/2} + 1), N = 2^a 3^b,
// over 64-bit RNS residues (moduli below 2^61), for Hopper (sm_90a):
// kernel B5 of the port.
//
// Replaces matrix_fhe_tpu/ops/ntt_3n.py:ntt_fwd / ntt_bwd, which are not
// Pallas kernels but XLA u64 Montgomery mod-matmuls (the TPU's MXU form).  It
// computes what the port's plain version (ops/ntt_3n.py) computes, bit for
// bit: every output is canonical in [0, q), so the order of the sums inside
// does not show.  With M = N/2 = R C (ops/ntt_3n.py:split_rc):
//
//   forward, for each branch b (z_b = z for b = 0, z^5 for b = 1):
//     A[j] = (lo[j] + z_b hi[j]) omega^(+-j)              fold and twist, on load
//     B[j0][k1] = twid[k1][j0] sum_j1 wr[k1][j1] A[j1 C + j0]         DFT_R
//     X[k2 R + k1] = sum_j0 wc[k2][j0] B[j0][k1]                      DFT_C
//     out[perm[b M + k]] = X[k]                           the E-sorted order, on store
//   inverse, the exact inverse of each step: the perm gather on load, the
//   inverse DFT_C, twiddle and DFT_R (1/M folded into wri), the untwist, and
//   the 2x2 CRT solve hi = (u - w) / (z - z^5), lo = u - z hi on store.
//
// Layout: one CTA for each (row, limb, branch) of an [..., L, N] tensor
// (limb = row mod L); the branch's M words sit in dynamic shared memory, and
// the second step's input in a second buffer, stored transposed with its rows
// padded by a word, so both matmuls read shared memory along consecutive
// words.  2 (R C) + C words: 97 KB at N = 12288 (R = 64, C = 96), 193 KB at
// 24576, 217 KB at 27648, the largest N whose buffers fit the 227 KB a CTA
// may hold.  The inverse's CRT solve needs both branches: the two CTAs of a
// (row, limb) form a thread-block cluster, and each reads the other's
// untwisted branch through distributed shared memory.
//
// Arithmetic: tables are in Montgomery form (x w 2^-64 mod q is a product).
// A matmul output sums its products in chunks of 8 as a 128-bit word
// (8 q^2 < q 2^64 for q < 2^61) with one Montgomery reduction a chunk, and
// the chunks mod q by conditional subtraction.  All arithmetic is unsigned.
// No library call: the mod-matmul is this kernel's own loop.  The kernels
// allocate nothing and launch on the caller's stream.

#include <atomic>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kChunk = 8;  // products summed before a reduction: 8 q^2 < q 2^64

__host__ __device__ constexpr size_t smem_words(int r, int c) {
  return 2 * static_cast<size_t>(r) * c + (c > r ? c : r);
}

// x - m if x >= m, else x (the wrapped difference is larger than x).
__device__ __forceinline__ u64 csub(u64 x, u64 m) { return min(x, x - m); }

// x w 2^-64 mod q in [0, q), for x, w < q < 2^61 and qinv = q^-1 mod 2^64.
__device__ __forceinline__ u64 mont(u64 x, u64 w, u64 q, u64 qinv) {
  const u64 hi = __umul64hi(x, w);
  const u64 m = x * w * qinv;
  return csub(hi - __umul64hi(m, q) + q, q);
}

// The Montgomery reduction of the 128-bit (hi, lo) < q 2^64, in [0, q).
__device__ __forceinline__ u64 redc(u64 hi, u64 lo, u64 q, u64 qinv) {
  return csub(hi - __umul64hi(lo * qinv, q) + q, q);
}

struct Limb {
  u64 q, qinv;
};

// lo:hi += w x, the 128-bit product summed into a 128-bit word.
__device__ __forceinline__ void mac(u64 w, u64 x, u64& lo, u64& hi) {
  const u64 p = w * x;
  lo += p;
  hi += __umul64hi(w, x) + (lo < p);
}

// out[k][b] = sum_a w[k][a] x[a][b] 2^-64 mod q for k < K, b < B, over a < A:
// x in shared memory with row stride ldx, w in device memory (row-major
// [K][A]); each output goes to store(o, k, b, value), o = k B + b.  Threads
// take consecutive b, so a warp reads consecutive words of x and one word
// of w.  A chunk of 8 products is unrolled (the hot loop: tools/ntt_sass.py
// --b5 counts its instructions a product), a shorter last chunk is not.
template <typename Store>
__device__ __forceinline__ void matmul(const u64* __restrict__ w, const u64* x, int K, int A,
                                       int B, int ldx, const Limb& l, Store store) {
  for (int o = threadIdx.x; o < K * B; o += blockDim.x) {
    const int k = o / B;
    const int b = o - k * B;
    const u64* wk = w + static_cast<size_t>(k) * A;
    const u64* xb = x + b;
    u64 acc = 0;
    int a0 = 0;
    for (; a0 + kChunk <= A; a0 += kChunk) {
      u64 lo = 0, hi = 0;
#pragma unroll
      for (int a = a0; a < a0 + kChunk; ++a) mac(__ldg(wk + a), xb[a * ldx], lo, hi);
      acc = csub(acc + redc(hi, lo, l.q, l.qinv), l.q);
    }
    if (a0 < A) {
      u64 lo = 0, hi = 0;
#pragma unroll 1
      for (int a = a0; a < A; ++a) mac(__ldg(wk + a), xb[a * ldx], lo, hi);
      acc = csub(acc + redc(hi, lo, l.q, l.qinv), l.q);
    }
    store(o, k, b, acc);
  }
}

struct Tables {
  int n, r, c, limbs;
  const u64* moduli;
  const u64* qinv;
  const u64* z_pow;     // [L, 2]
  const u64* tw1;       // [L, M]  forward twist (branch 0), or untwist (branch 0)
  const u64* tw2;       // [L, M]  branch 1
  const u64* w1;        // [L, R, R] forward DFT_R, or [L, C, C] inverse DFT_C
  const u64* w2;        // [L, C, C] forward DFT_C, or [L, R, R] inverse DFT_R
  const u64* twid;      // [L, R, C]
  const u64* inv_diff;  // [L] (inverse only)
  const long long* perm;  // [N]
};

__global__ void __launch_bounds__(kThreads)
ntt3n_fwd_kernel(const u64* __restrict__ in, u64* __restrict__ out, Tables t) {
  extern __shared__ u64 smem[];
  const int R = t.r, C = t.c, M = R * C;
  const int branch = blockIdx.x & 1;
  const size_t row = blockIdx.x >> 1;
  const int limb = static_cast<int>(row % t.limbs);
  const Limb l = {t.moduli[limb], t.qinv[limb]};
  u64* a = smem;               // [R][C]: the twisted branch, j = j1 C + j0
  u64* bt = smem + M;          // [C][R + 1]: DFT_R's output, transposed
  const u64* src = in + row * t.n;
  const u64 zb = t.z_pow[2 * limb + branch];
  const u64* tw = (branch ? t.tw2 : t.tw1) + static_cast<size_t>(limb) * M;
  for (int j = threadIdx.x; j < M; j += blockDim.x) {
    const u64 lo = __ldg(src + j), hi = __ldg(src + M + j);
    a[j] = mont(csub(lo + mont(hi, zb, l.q, l.qinv), l.q), __ldg(tw + j), l.q, l.qinv);
  }
  __syncthreads();
  const u64* twid = t.twid + static_cast<size_t>(limb) * M;
  matmul(t.w1 + static_cast<size_t>(limb) * R * R, a, R, R, C, C, l,
         [&](int o, int k1, int j0, u64 v) {
           bt[j0 * (R + 1) + k1] = mont(v, __ldg(twid + o), l.q, l.qinv);
         });
  __syncthreads();
  u64* dst = out + row * t.n;
  const long long* perm = t.perm + branch * M;
  matmul(t.w2 + static_cast<size_t>(limb) * C * C, bt, C, C, R, R + 1, l,
         [&](int o, int, int, u64 v) { dst[__ldg(perm + o)] = v; });
}

__global__ void __launch_bounds__(kThreads)
ntt3n_bwd_kernel(const u64* __restrict__ in, u64* __restrict__ out, Tables t) {
  extern __shared__ u64 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int R = t.r, C = t.c, M = R * C;
  const int branch = static_cast<int>(cluster.block_rank());
  const size_t row = blockIdx.x >> 1;
  const int limb = static_cast<int>(row % t.limbs);
  const Limb l = {t.moduli[limb], t.qinv[limb]};
  u64* a = smem;               // [C][R]: the branch's evaluations, k = k2 R + k1
  u64* b = smem + M;           // [R][C + 1]: inverse DFT_C's output, transposed
  const u64* src = in + row * t.n;
  const long long* perm = t.perm + branch * M;
  for (int k = threadIdx.x; k < M; k += blockDim.x) a[k] = __ldg(src + __ldg(perm + k));
  __syncthreads();
  const u64* twid = t.twid + static_cast<size_t>(limb) * M;
  matmul(t.w1 + static_cast<size_t>(limb) * C * C, a, C, C, R, R, l,
         [&](int, int j0, int k1, u64 v) {
           b[k1 * (C + 1) + j0] = mont(v, __ldg(twid + k1 * C + j0), l.q, l.qinv);
         });
  __syncthreads();
  // inverse DFT_R, then the untwist, into a: the branch's u (or w) at j
  const u64* untw = (branch ? t.tw2 : t.tw1) + static_cast<size_t>(limb) * M;
  matmul(t.w2 + static_cast<size_t>(limb) * R * R, b, R, R, C, C + 1, l,
         [&](int o, int, int, u64 v) { a[o] = mont(v, __ldg(untw + o), l.q, l.qinv); });
  cluster.sync();  // both branches untwisted
  const u64* u = cluster.map_shared_rank(smem, 0);
  const u64* w = cluster.map_shared_rank(smem, 1);
  const u64 z = t.z_pow[2 * limb], inv_diff = t.inv_diff[limb];
  u64* dst = out + row * t.n;
  for (int j = threadIdx.x + branch * blockDim.x; j < M; j += 2 * blockDim.x) {
    const u64 uj = u[j];
    const u64 hi = mont(csub(uj + l.q - w[j], l.q), inv_diff, l.q, l.qinv);
    dst[j] = csub(uj + l.q - mont(hi, z, l.q, l.qinv), l.q);
    dst[M + j] = hi;
  }
  cluster.sync();  // the other CTA reads this one's buffer until here
}

// Shared memory a kernel may use is raised above 48 KB once per kernel,
// device and size, here to the largest size launched so far.
std::atomic<size_t> configured[2][64];

cudaError_t configure(const void* kernel, bool fwd, size_t smem, int dev) {
  std::atomic<size_t>& done = configured[fwd][dev & 63];
  if (done.load(std::memory_order_acquire) >= smem) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  size_t cur = done.load(std::memory_order_relaxed);
  while (cur < smem && !done.compare_exchange_weak(cur, smem)) {
  }
  return cudaSuccess;
}

// Launch on device `dev` (the calling thread's device is switched to it for
// the launch and back) and `stream`, a stream of that device.
int launch(bool fwd, const void* in, void* out, const Tables& t, int rows, int dev,
           void* stream) {
  if (rows < 0 || t.r < 2 || t.c < t.r || 2 * t.r * t.c != t.n || t.limbs < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* kernel = fwd ? reinterpret_cast<const void*>(ntt3n_fwd_kernel)
                           : reinterpret_cast<const void*>(ntt3n_bwd_kernel);
  const size_t smem = sizeof(u64) * smem_words(t.r, t.c);
  err = configure(kernel, fwd, smem, dev);
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(rows) * 2, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = fwd ? 0 : 1;
    const u64* src = static_cast<const u64*>(in);
    u64* dst = static_cast<u64*>(out);
    err = fwd ? cudaLaunchKernelEx(&cfg, ntt3n_fwd_kernel, src, dst, t)
              : cudaLaunchKernelEx(&cfg, ntt3n_bwd_kernel, src, dst, t);
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  if (prev != dev) cudaSetDevice(prev);
  return static_cast<int>(err);
}

}  // namespace

// C entry points, bound with ctypes (matrix_fhe_tpu_torch/ops/ntt3n_cuda.py).
// Pointers are device pointers of int64 tensors whose words are read as
// uint64 (perm: int64 indices); `rows` is the number of length-N rows of
// `in` and `out`, `limbs` the L of the tables (row r uses limb r mod L);
// r c = N / 2 with 2 <= r <= c; `device` is the CUDA device of the pointers
// and `stream` a stream of it.  The return value is the CUDA error of the
// launch (0 on success; cudaErrorInvalidValue for a bad size).

extern "C" int mfhe_ntt3n_fwd(const void* in, void* out, const void* moduli, const void* qinv,
                              const void* z_pow, const void* tw1, const void* tw2,
                              const void* wr, const void* wc, const void* twid,
                              const void* perm, int rows, int limbs, int n, int r, int c,
                              int device, void* stream) {
  const Tables t = {n, r, c, limbs,
                    static_cast<const u64*>(moduli), static_cast<const u64*>(qinv),
                    static_cast<const u64*>(z_pow), static_cast<const u64*>(tw1),
                    static_cast<const u64*>(tw2), static_cast<const u64*>(wr),
                    static_cast<const u64*>(wc), static_cast<const u64*>(twid), nullptr,
                    static_cast<const long long*>(perm)};
  return launch(true, in, out, t, rows, device, stream);
}

extern "C" int mfhe_ntt3n_bwd(const void* in, void* out, const void* moduli, const void* qinv,
                              const void* z_pow, const void* untw1, const void* untw2,
                              const void* wci, const void* wri, const void* twidi,
                              const void* inv_diff, const void* perm, int rows, int limbs,
                              int n, int r, int c, int device, void* stream) {
  const Tables t = {n, r, c, limbs,
                    static_cast<const u64*>(moduli), static_cast<const u64*>(qinv),
                    static_cast<const u64*>(z_pow), static_cast<const u64*>(untw1),
                    static_cast<const u64*>(untw2), static_cast<const u64*>(wci),
                    static_cast<const u64*>(wri), static_cast<const u64*>(twidi),
                    static_cast<const u64*>(inv_diff), static_cast<const long long*>(perm)};
  return launch(false, in, out, t, rows, device, stream);
}
