// The local step of the coefficient-sharded four-step NTT, for Hopper
// (sm_90a): kernel B6 of the port.
//
// Replaces the shard-local body of matrix_fhe_tpu/parallel/ntt_sharded.py:
// ntt_sharded (its `local`, :127-138: _mod_matmul_left :92, mm.mred,
// _partial_matmul_right :100), which is not a Pallas kernel but XLA u64
// Montgomery mod-matmuls.  For one rank's column block x [lead, L, R, c]
// (c = C / k columns from column col0 of the [R, C] view) it computes the
// partial product
//
//   P[b, l] = ((A_l @ x[b, l]) .* T_l[:, col0:col0+c]) @ BT_l[col0:col0+c, :]  mod q_l
//
// [lead, L, R, C], every word canonical in [0, q), where A, T and B^T are
// held in Montgomery form (MForm: a * 2^64 mod q), so each product of a
// table word and a residue is a Montgomery product a * b * 2^-64 mod q.
// The partials of the k ranks sum to the NTT (parallel/ntt_sharded.py does
// that with one all-to-all and a modular sum).  Words are int64 tensors
// read as uint64; moduli below 2^61.
//
// What bounds it on this card: at the flagship's N = 2^14 (R = C = 128),
// L = 10 limbs and a lead of 2, a k = 8 shard's step is 10.5 M 64-bit
// multiply-accumulates (2 * 10 * 128 * 16 * 128 for each of the two
// products) and ~4.6 MB of words (the block, the rows of A, T and B^T the
// block needs, and the [2, 10, 128, 128] partial): a few us of either
// the FMA pipe's 32-bit multiply-adds or device memory, so the operations
// bound it (chip_smoke.py's _b6_bound counts them).
//
// What the design does about it (a simple kernel, right first):
//   * One CTA of 256 threads for each (lead, limb, tile of `ti` output
//     rows), ti = min(R, 16, 2048 / C), so a thread holds at most 8 outputs
//     of either product in registers.
//   * Each sum of products is accumulated lazily in 128 bits (the 64-bit
//     product's low word by a multiply, its high word by __umul64hi, a
//     carry between them) over a chunk of at most 32 terms (each term
//     < q^2 < 2^122, so a chunk's sum stays below 2^127), then reduced
//     once: hi 2^64 + lo -> (hi mod q by Barrett on the high word, + lo 2^-64
//     mod q by a Montgomery step) mod q, which is the sum of the chunk's
//     Montgomery products mod q.  Any exact order of summation gives the
//     same canonical word.
//   * The chunks of A's rows and of the block (step 1), and of B^T's rows
//     (step 2), are staged in shared memory, one coalesced loop each; the
//     [ti, c] tile W = (A @ x) .* T stays in shared memory between the two
//     products; the output row tile is written once, coalesced.
// Tensor cores and TMA are later work: the tensor cores have no 64-bit
// integer product.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kMaxOut = 8;   // outputs a thread holds in either product
constexpr int kChunk = 32;   // terms summed in 128 bits between reductions
constexpr int kMaxCols = 512;  // C: a chunk of B^T's rows, 32 C words, in shared memory

struct Modulus {
  u64 q, qinv, bhi;
};

// lo/hi += a * b (a 128-bit accumulator; the caller keeps it below 2^128)
__device__ __forceinline__ void mac(u64& lo, u64& hi, u64 a, u64 b) {
  const u64 plo = a * b;
  const u64 phi = __umul64hi(a, b);
  lo += plo;
  hi += phi + (lo < plo ? 1ull : 0ull);
}

// (hi 2^64 + lo) 2^-64 mod q, canonical: hi mod q (BRedAdd: any 64-bit
// word) plus lo 2^-64 mod q (IMForm), each in [0, q), then one subtraction.
__device__ __forceinline__ u64 reduce(u64 lo, u64 hi, const Modulus& m) {
  u64 h = hi - __umul64hi(hi, m.bhi) * m.q;
  if (h >= m.q) h -= m.q;
  const u64 t = __umul64hi(lo * m.qinv, m.q);  // lo 2^-64 == -t (mod q)
  u64 r = h + (m.q - t);                        // in (0, 2q)
  return r >= m.q ? r - m.q : r;
}

__device__ __forceinline__ u64 add_mod(u64 a, u64 b, u64 q) {
  const u64 s = a + b;
  return s >= q ? s - q : s;
}

__global__ void __launch_bounds__(kThreads)
    local_step_kernel(const u64* __restrict__ x, u64* __restrict__ out,
                      const u64* __restrict__ a_mat, const u64* __restrict__ tw,
                      const u64* __restrict__ bt, const u64* __restrict__ moduli,
                      const u64* __restrict__ qinv, const u64* __restrict__ bhi, int limbs,
                      int R, int C, int c, int col0, int ti) {
  extern __shared__ u64 smem[];
  u64* w_s = smem;                // [ti, c]: W = (A @ x) .* T, this tile's rows
  u64* a_s = w_s + ti * c;        // [ti, kChunk]: a chunk of A's rows
  u64* big = a_s + ti * kChunk;   // [kChunk, c] of the block or [kChunk, C] of B^T

  const int tiles = R / ti;
  const int bl = blockIdx.x / tiles;  // (lead, limb) row of the block
  const int i0 = (blockIdx.x % tiles) * ti;
  const int l = bl % limbs;
  const Modulus m{moduli[l], qinv[l], bhi[l]};
  const u64* xb = x + static_cast<size_t>(bl) * R * c;
  const u64* al = a_mat + static_cast<size_t>(l) * R * R;
  const u64* tl = tw + static_cast<size_t>(l) * R * C;
  const u64* btl = bt + static_cast<size_t>(l) * C * C;
  u64* ob = out + static_cast<size_t>(bl) * R * C;
  const int t = threadIdx.x;

  // -- step 1: the tile's rows of A @ x, then .* T ----------------------------
  const int n1 = ti * c;
  u64 s[kMaxOut];
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) s[k] = 0;
  for (int r0 = 0; r0 < R; r0 += kChunk) {
    const int rk = min(kChunk, R - r0);
    __syncthreads();
    for (int e = t; e < ti * rk; e += kThreads) {
      const int i = e / rk, r = e - i * rk;
      a_s[i * kChunk + r] = al[static_cast<size_t>(i0 + i) * R + r0 + r];
    }
    for (int e = t; e < rk * c; e += kThreads) big[e] = xb[static_cast<size_t>(r0) * c + e];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxOut; ++k) {
      const int o = t + k * kThreads;
      if (o < n1) {
        const int i = o / c, j = o - i * c;
        u64 lo = 0, hi = 0;
        for (int r = 0; r < rk; ++r) mac(lo, hi, a_s[i * kChunk + r], big[r * c + j]);
        s[k] = add_mod(s[k], reduce(lo, hi, m), m.q);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) {
    const int o = t + k * kThreads;
    if (o < n1) {
      const int i = o / c, j = o - i * c;
      const u64 tw_ij = tl[static_cast<size_t>(i0 + i) * C + col0 + j];
      w_s[o] = reduce(s[k] * tw_ij, __umul64hi(s[k], tw_ij), m);
    }
  }

  // -- step 2: W @ B^T's rows col0 .. col0 + c ---------------------------------
  const int n2 = ti * C;
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) s[k] = 0;
  for (int m0 = 0; m0 < c; m0 += kChunk) {
    const int mk = min(kChunk, c - m0);
    __syncthreads();  // W written; the last chunk of step 1 or 2 consumed
    for (int e = t; e < mk * C; e += kThreads)
      big[e] = btl[static_cast<size_t>(col0 + m0) * C + e];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxOut; ++k) {
      const int o = t + k * kThreads;
      if (o < n2) {
        const int i = o / C, j = o - i * C;
        u64 lo = 0, hi = 0;
        for (int mm = 0; mm < mk; ++mm) mac(lo, hi, w_s[i * c + m0 + mm], big[mm * C + j]);
        s[k] = add_mod(s[k], reduce(lo, hi, m), m.q);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) {
    const int o = t + k * kThreads;
    if (o < n2) {
      const int i = o / C, j = o - i * C;
      ob[static_cast<size_t>(i0 + i) * C + j] = s[k];
    }
  }
}

int tile_rows(int R, int C) {
  int ti = R < 16 ? R : 16;
  while (ti > 1 && ti * C > kMaxOut * kThreads) ti /= 2;
  return ti;
}

}  // namespace

// C entry point, bound with ctypes (matrix_fhe_tpu_torch/ops/ntt_sharded_cuda.py).
// Pointers are device pointers of contiguous int64 tensors read as uint64:
// x [lead, limbs, R, c], out [lead, limbs, R, C], a_mat [limbs, R, R],
// tw [limbs, R, C], bt [limbs, C, C], moduli / qinv / bhi [limbs];
// col0 the block's first column.  R <= C powers of two, C <= 512 (N <= 2^18),
// c dividing C.  Launches on `stream` of `device` (the calling thread's
// device is switched to it for the launch and back) and returns the CUDA
// error of the launch (0 on success).
extern "C" int mfhe_ntt_sharded_local(const void* x, void* out, const void* a_mat,
                                      const void* tw, const void* bt, const void* moduli,
                                      const void* qinv, const void* bhi, int lead, int limbs,
                                      int R, int C, int c, int col0, int device, void* stream) {
  if (lead < 0 || limbs <= 0 || R <= 0 || C <= 0 || c <= 0 || C > kMaxCols || R > C ||
      C % c || col0 < 0 || col0 + c > C || R & (R - 1) || C & (C - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lead == 0) return 0;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ti = tile_rows(R, C);
  const size_t smem = sizeof(u64) * (static_cast<size_t>(ti) * c + ti * kChunk +
                                     static_cast<size_t>(kChunk) * C);
  err = cudaFuncSetAttribute(local_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) {
    const unsigned blocks = static_cast<unsigned>(lead) * limbs * (R / ti);
    local_step_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const u64*>(x), static_cast<u64*>(out), static_cast<const u64*>(a_mat),
        static_cast<const u64*>(tw), static_cast<const u64*>(bt),
        static_cast<const u64*>(moduli), static_cast<const u64*>(qinv),
        static_cast<const u64*>(bhi), limbs, R, C, c, col0, ti);
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
