// Negacyclic NTT / inverse NTT over int32 RNS residues, for Hopper (sm_90a),
// applied once per launch or k times in one launch.
//
// Replaces the TPU's four-step int8-digit matmul NTTs, all through the two
// entry points mfhe_ntt_chain_fwd / mfhe_ntt_chain_bwd, which apply the
// transform k >= 1 times in one launch:
//   * matrix_fhe_tpu/ops/pallas_ntt2.py:_transform (ntt_fwd / ntt_bwd),
//     q < 2^23: k = 1;
//   * matrix_fhe_tpu/ops/pallas_ntt2.py:ntt_chain, the same transform k times
//     in one launch, bit-exact to k sequential calls;
//   * matrix_fhe_tpu/ops/pallas_ntt.py:_transform (v1, q < 2^22, Dekker f32
//     arithmetic): the same function on a smaller prime family, so its
//     wrapper (ops/ntt_w22.py) launches the same entry points with k = 1.
// Same contract as those: each row of an [..., L, N] tensor (limb = row mod L)
// is transformed under its modulus q < 2^23, the output is in the reference's
// bit-reversed order (out[i] = x(psi^(2 brv(i) + 1)), ring/ntt.go) and
// canonical in [0, q).
//
// What bounds it on this card: a limb-transform reads and writes N * 4 bytes
// (64 KB each way at N = 2^14) and runs log2(N) butterfly stages of N/2
// butterflies, each stage needing every value of the previous one, so the
// stages are separated by block-wide barriers.  A butterfly is 7 integer
// operations (a Shoup product: two 32-bit multiplies and a high multiply;
// an add, a subtract and a conditional subtract), which the SMs do in their
// int32 pipes (the multiplies on the FMA pipe, the rest on the ALU pipe, 128
// a clock per SM together); the TPU kernel's digit planes existed only
// because the TPU has no widening multiply.  A single transform at the
// step's shapes is bound by device memory (a few microseconds), its
// operations taking about half that; k chained transforms move the same
// bytes and k times the operations, so the chain is bound by the operations.
//
// What the design does about it: one thread block per row keeps the whole
// row in dynamic shared memory (<= 128 KB for N <= 2^15), so device memory
// is touched once to load and once to store, however many transforms run in
// between; all stages run out of shared memory.  This is the per-row form of
// the TPU chain's persistent VMEM scratch: rows are independent, so a block
// needs only its own row resident.  The forward transform is Cooley-Tukey
// over the bit-reversed psi-power table, the inverse Gentleman-Sande over the
// psi^-1 table followed by N^-1 (the Longa-Naehrig layout of ring/ntt.go).
// Values stay lazily in [0, 4q) (forward) or [0, 2q) (inverse) from one
// stage, and one chained transform, to the next: q < 2^23 keeps them far
// below 2^32, and every operation is exact mod q, so the one reduction to
// [0, q) at the store gives the same word as reducing after every transform.
// Twiddles and their Shoup quotients are read from device memory (they stay
// in L2), so a block needs only its row in shared memory: 64 KB at
// N = 2^14, three blocks to an SM.
//
// All arithmetic is unsigned: signed overflow is undefined in CUDA C.
// The kernels allocate nothing and launch on the caller's stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;

// w * x mod q in [0, 2q), for any x < 2^32, w < q < 2^31 and
// w_shoup = floor(w * 2^32 / q).  The true value is below 2q < 2^32, so the
// wrapping unsigned multiply-subtract returns it exactly.
__device__ __forceinline__ uint32_t shoup_mul(uint32_t x, uint32_t w,
                                              uint32_t w_shoup, uint32_t q) {
  return w * x - __umulhi(w_shoup, x) * q;
}

__device__ __forceinline__ void load_row(uint32_t* a, const uint32_t* src, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) a[k] = src[k];
  __syncthreads();
}

// One forward transform of the row in shared memory.  Cooley-Tukey: at
// stage s, group i of m = 2^s pairs (j, j + t), t = N/2m, twiddle
// psi^brv(m + i).  In: [0, 4q); out: [0, 4q).
__device__ __forceinline__ void fwd_stages(uint32_t* a, const uint32_t* w,
                                           const uint32_t* ws, uint32_t q,
                                           int logn) {
  const int n = 1 << logn;
  const uint32_t two_q = 2 * q;
  for (int s = 0; s < logn; ++s) {
    const int log_t = logn - 1 - s;
    const int t = 1 << log_t;
    const int m = 1 << s;
    for (int k = threadIdx.x; k < n / 2; k += blockDim.x) {
      const int i = k >> log_t;
      const int j = (i << (log_t + 1)) | (k & (t - 1));
      uint32_t u = a[j];
      if (u >= two_q) u -= two_q;                                  // [0, 2q)
      const uint32_t v = shoup_mul(a[j + t], w[m + i], ws[m + i], q);  // [0, 2q)
      a[j] = u + v;
      a[j + t] = u + two_q - v;
    }
    __syncthreads();
  }
}

// One inverse transform of the row, without the final N^-1: Gentleman-Sande,
// stages in reverse order.  In: [0, 2q); out: [0, 2q).
__device__ __forceinline__ void bwd_stages(uint32_t* a, const uint32_t* w,
                                           const uint32_t* ws, uint32_t q,
                                           int logn) {
  const int n = 1 << logn;
  const uint32_t two_q = 2 * q;
  for (int s = logn - 1; s >= 0; --s) {
    const int log_t = logn - 1 - s;
    const int t = 1 << log_t;
    const int m = 1 << s;
    for (int k = threadIdx.x; k < n / 2; k += blockDim.x) {
      const int i = k >> log_t;
      const int j = (i << (log_t + 1)) | (k & (t - 1));
      const uint32_t u = a[j];
      const uint32_t v = a[j + t];
      uint32_t x = u + v;
      if (x >= two_q) x -= two_q;
      a[j] = x;
      a[j + t] = shoup_mul(u + two_q - v, w[m + i], ws[m + i], q);
    }
    __syncthreads();
  }
}

// `steps` forward transforms of each row; steps = 1 is ntt_fwd.
__global__ void ntt_fwd_kernel(const uint32_t* __restrict__ in,
                               uint32_t* __restrict__ out,
                               const uint32_t* __restrict__ psi,
                               const uint32_t* __restrict__ psi_shoup,
                               const uint32_t* __restrict__ moduli,
                               int limbs, int logn, int steps) {
  extern __shared__ uint32_t a[];
  const int n = 1 << logn;
  const size_t row = blockIdx.x;
  const int limb = static_cast<int>(row % limbs);
  const uint32_t q = moduli[limb];
  const uint32_t two_q = 2 * q;
  const uint32_t* w = psi + static_cast<size_t>(limb) * n;
  const uint32_t* ws = psi_shoup + static_cast<size_t>(limb) * n;

  load_row(a, in + row * n, n);
  for (int step = 0; step < steps; ++step) fwd_stages(a, w, ws, q, logn);
  uint32_t* dst = out + row * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    uint32_t v = a[k];
    if (v >= two_q) v -= two_q;
    if (v >= q) v -= q;
    dst[k] = v;
  }
}

// `steps` inverse transforms of each row; steps = 1 is ntt_bwd.
__global__ void ntt_bwd_kernel(const uint32_t* __restrict__ in,
                               uint32_t* __restrict__ out,
                               const uint32_t* __restrict__ ipsi,
                               const uint32_t* __restrict__ ipsi_shoup,
                               const uint32_t* __restrict__ moduli,
                               const uint32_t* __restrict__ ninv,
                               const uint32_t* __restrict__ ninv_shoup,
                               int limbs, int logn, int steps) {
  extern __shared__ uint32_t a[];
  const int n = 1 << logn;
  const size_t row = blockIdx.x;
  const int limb = static_cast<int>(row % limbs);
  const uint32_t q = moduli[limb];
  const uint32_t* w = ipsi + static_cast<size_t>(limb) * n;
  const uint32_t* ws = ipsi_shoup + static_cast<size_t>(limb) * n;
  const uint32_t ni = ninv[limb];
  const uint32_t ni_shoup = ninv_shoup[limb];

  load_row(a, in + row * n, n);
  for (int step = 0; step < steps; ++step) {
    bwd_stages(a, w, ws, q, logn);
    if (step + 1 == steps) break;
    // N^-1 of every transform but the last, which is applied at the store
    for (int k = threadIdx.x; k < n; k += blockDim.x)
      a[k] = shoup_mul(a[k], ni, ni_shoup, q);                     // [0, 2q)
    __syncthreads();
  }
  uint32_t* dst = out + row * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    uint32_t v = shoup_mul(a[k], ni, ni_shoup, q);
    if (v >= q) v -= q;
    dst[k] = v;
  }
}

// Shared memory and threads for a row of 2^logn words; the caller's current
// device is the tensors' device.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int logn, size_t* smem, int* threads) {
  *smem = sizeof(uint32_t) << logn;
  *threads = (1 << (logn - 1)) < kMaxThreads ? (1 << (logn - 1)) : kMaxThreads;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

// C entry points, bound with ctypes (matrix_fhe_tpu_torch/ops/ntt_cuda.py).
// Pointers are device pointers of int32 tensors whose words are read as
// uint32; `rows` is the number of length-2^logn rows; `k` >= 1 is the number
// of chained transforms; the return value is the CUDA error of the launch
// (0 on success).

extern "C" int mfhe_ntt_chain_fwd(const void* in, void* out, const void* psi,
                                  const void* psi_shoup, const void* moduli,
                                  int rows, int limbs, int logn, int k,
                                  void* stream) {
  size_t smem;
  int threads;
  cudaError_t err = prepare(ntt_fwd_kernel, logn, &smem, &threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_fwd_kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(psi), static_cast<const uint32_t*>(psi_shoup),
      static_cast<const uint32_t*>(moduli), limbs, logn, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mfhe_ntt_chain_bwd(const void* in, void* out, const void* ipsi,
                                  const void* ipsi_shoup, const void* moduli,
                                  const void* ninv, const void* ninv_shoup,
                                  int rows, int limbs, int logn, int k,
                                  void* stream) {
  size_t smem;
  int threads;
  cudaError_t err = prepare(ntt_bwd_kernel, logn, &smem, &threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_bwd_kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(ipsi), static_cast<const uint32_t*>(ipsi_shoup),
      static_cast<const uint32_t*>(moduli), static_cast<const uint32_t*>(ninv),
      static_cast<const uint32_t*>(ninv_shoup), limbs, logn, k);
  return static_cast<int>(cudaGetLastError());
}
