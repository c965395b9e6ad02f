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
// canonical in [0, q).  16 <= N <= 2^15.
//
// What bounds it on this card: a limb-transform reads and writes N * 4 bytes
// (64 KB each way at N = 2^14) and runs log2(N) butterfly stages of N/2
// butterflies, each stage needing every value of the previous one.  A
// butterfly is 7 integer operations (a Shoup product: two 32-bit multiplies
// and a high multiply; an add, a subtract and a conditional subtract).  A
// single transform at the step's shapes is bound by device memory (a few
// microseconds); k chained transforms move the same bytes and k times the
// operations, so the chain is bound by the operations.
//
// What the design does about it:
//   * Radix passes in registers.  The forward transform is Cooley-Tukey over
//     the bit-reversed psi-power table, the inverse Gentleman-Sande over the
//     psi^-1 table with N^-1 (the Longa-Naehrig layout of ring/ntt.go).  The
//     stages are grouped into passes of R <= 4: a thread loads the 2^R words
//     of a group from shared memory, runs the R stages on them in registers
//     with the 2^R - 1 twiddle pairs of the group (loaded once, as vectors,
//     from a per-limb base), and writes them back.  A 2^14 transform is 4
//     passes (3 + 3 + 4 + 4 stages) and 4 block barriers, not 14.  Every
//     size is a template: group strides and addresses are compile-time
//     offsets from one base a group.
//   * One row a block, the row in dynamic shared memory, padded by a word
//     every 32 (phys(j) = j + j/32) so that all passes but one are free of
//     bank conflicts (that one has two-way conflicts).  Device memory is
//     read once and written once, however many transforms run in between.
//   * A row split over a thread-block cluster of C CTAs (C = 2, 4, 8), for
//     latency: CTA c holds words [c N/C, (c+1) N/C).  The first
//     log2(C) forward stages pair words N/C or more apart, across CTAs; they
//     run first as one radix-C pass whose thread gathers its C words at
//     stride N/C and scatters them to the C CTAs through distributed shared
//     memory.  All later stages stay in one CTA's chunk, so the local passes
//     run as a transform of N/C words.  The inverse is the mirror: local
//     passes, then the radix-C pass with N^-1, stored to device memory.
//     The wrapper picks C (ops/ntt_cuda.py:geometry, from measured times):
//     8 for one transform of few rows, or of N >= 2^14, where a row's small
//     CTAs on 8 SMs finish sooner than one block on one; otherwise as few
//     as cover the card's SMs, since each step of a split row pays a pass
//     through distributed shared memory and two cluster barriers.
//   * Values stay lazily in [0, 4q) (forward) or [0, 2q) (inverse) from one
//     stage, and one chained transform, to the next: q < 2^23 keeps them far
//     below 2^32, and every operation is exact mod q, so the one reduction to
//     [0, q) at the store gives the same word as reducing after every
//     transform.  Twiddles and their Shoup quotients are read through the
//     read-only cache (they stay in L2).
//
// All arithmetic is unsigned: signed overflow is undefined in CUDA C.
// The kernels allocate nothing and launch on the caller's stream.

#include <atomic>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#ifndef MFHE_NTT_LOGN
#error "build with -DMFHE_NTT_LOGN=<log2 N>, 4 to 15"
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMinLogN = 4;
constexpr int kMaxLogN = 15;
static_assert(MFHE_NTT_LOGN >= kMinLogN && MFHE_NTT_LOGN <= kMaxLogN, "4 <= log2 N <= 15");
// Rows split over a cluster only from N = 2^10 on (chunks of >= 128 words).
constexpr int kMinClusterLogN = 10;

// ----------------------------------------------------------------------------
// Geometry, all compile-time for a (log2 N, C) kernel.
// ----------------------------------------------------------------------------

__host__ __device__ constexpr int log2i(int c) { return c <= 1 ? 0 : 1 + log2i(c / 2); }

// Shared-memory word of local word j: one pad word every 32.  For x, y with
// disjoint bits phys(x | y) = phys(x) + phys(y), so a group's words are at
// compile-time offsets from phys(base).
__host__ __device__ constexpr uint32_t phys(uint32_t j) { return j + (j >> 5); }

// Threads of a CTA holding 2^lognl words: one a group of 16, 32 to 512.
__host__ __device__ constexpr int threads_for(int lognl) {
  return lognl - 4 <= 5 ? 32 : (lognl - 4 >= 9 ? kMaxThreads : 1 << (lognl - 4));
}

constexpr size_t smem_for(int lognl) {
  return sizeof(uint32_t) * phys(1u << lognl);
}

// The local stages 0 .. lognl-1 in P = ceil(lognl / 4) passes, as even as
// possible, the shorter ones first: 14 = 3 + 3 + 4 + 4, 11 = 3 + 4 + 4
// (the order that leaves one pass of a 2^14 row with two-way bank
// conflicts, the other order two).  Stages of the pass that starts at local
// stage s0, and of the one that ends at stage `end`.
__host__ __device__ constexpr int pass_count(int lognl) { return (lognl + 3) / 4; }
__host__ __device__ constexpr int longer_from(int lognl) {
  return (pass_count(lognl) - lognl % pass_count(lognl)) * (lognl / pass_count(lognl));
}
__host__ __device__ constexpr int pass_from(int lognl, int s0) {
  return lognl / pass_count(lognl) + (s0 >= longer_from(lognl));
}
__host__ __device__ constexpr int pass_to(int lognl, int end) {
  return lognl / pass_count(lognl) + (end > longer_from(lognl));
}

// ----------------------------------------------------------------------------
// Arithmetic.
// ----------------------------------------------------------------------------

// w * x mod q in [0, 2q), for any x < 2^32, w < q < 2^31 and
// w_shoup = floor(w * 2^32 / q).  The true value is below 2q < 2^32, so the
// wrapping unsigned multiply-subtract returns it exactly.
__device__ __forceinline__ uint32_t shoup_mul(uint32_t x, uint32_t w,
                                              uint32_t w_shoup, uint32_t q) {
  return w * x - __umulhi(w_shoup, x) * q;
}

// x - m if x >= m, else x (the wrapped difference is larger than x).
__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t m) {
  return min(x, x - m);
}

// Cooley-Tukey: (u, v) -> (u + w v, u - w v).  In and out: [0, 4q).
__device__ __forceinline__ void ct_butterfly(uint32_t& u, uint32_t& v, uint32_t w,
                                             uint32_t ws, uint32_t q, uint32_t two_q) {
  const uint32_t a = csub(u, two_q);                 // [0, 2q)
  const uint32_t b = shoup_mul(v, w, ws, q);         // [0, 2q)
  u = a + b;
  v = a + two_q - b;
}

// Gentleman-Sande: (u, v) -> (u + v, w (u - v)).  In and out: [0, 2q).
__device__ __forceinline__ void gs_butterfly(uint32_t& u, uint32_t& v, uint32_t w,
                                             uint32_t ws, uint32_t q, uint32_t two_q) {
  const uint32_t s = csub(u + v, two_q);
  v = shoup_mul(u + two_q - v, w, ws, q);
  u = s;
}

// The 2^R - 1 twiddles of a group at pass-local stage d = 0 .. R-1 are the
// 2^d consecutive table words from g 2^d; they go to t[2^d + p].  Aligned
// vector loads: g 2^d is a multiple of 2^d, and a limb's table starts on a
// multiple of 16 words.
template <int R>
__device__ __forceinline__ void load_twiddles(uint32_t (&t)[1 << R],
                                              const uint32_t* __restrict__ w,
                                              uint32_t g) {
  t[1] = __ldg(w + g);
  if constexpr (R >= 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(w + 2 * g));
    t[2] = v.x; t[3] = v.y;
  }
  if constexpr (R >= 3) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(w + 4 * g));
    t[4] = v.x; t[5] = v.y; t[6] = v.z; t[7] = v.w;
  }
  if constexpr (R >= 4) {
    const uint4* p = reinterpret_cast<const uint4*>(w + 8 * g);
    const uint4 v = __ldg(p), u = __ldg(p + 1);
    t[8] = v.x; t[9] = v.y; t[10] = v.z; t[11] = v.w;
    t[12] = u.x; t[13] = u.y; t[14] = u.z; t[15] = u.w;
  }
}

// R stages on the 2^R words x[k] = word base + k * stride of a group: stage
// d pairs k and k + 2^(R-1-d) with twiddle t[2^d + (k >> (R - d))].
template <int R>
__device__ __forceinline__ void fwd_radix(uint32_t (&x)[1 << R], const uint32_t (&t)[1 << R],
                                          const uint32_t (&ts)[1 << R], uint32_t q) {
  const uint32_t two_q = 2 * q;
#pragma unroll
  for (int d = 0; d < R; ++d) {
    const int half = 1 << (R - 1 - d);
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) {
      if (k & half) continue;
      const int i = (1 << d) + (k >> (R - d));
      ct_butterfly(x[k], x[k + half], t[i], ts[i], q, two_q);
    }
  }
}

template <int R>
__device__ __forceinline__ void bwd_radix(uint32_t (&x)[1 << R], const uint32_t (&t)[1 << R],
                                          const uint32_t (&ts)[1 << R], uint32_t q) {
  const uint32_t two_q = 2 * q;
#pragma unroll
  for (int d = R - 1; d >= 0; --d) {
    const int half = 1 << (R - 1 - d);
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) {
      if (k & half) continue;
      const int i = (1 << d) + (k >> (R - d));
      gs_butterfly(x[k], x[k + half], t[i], ts[i], q, two_q);
    }
  }
}

// The per-row state every pass needs.
struct Row {
  const uint32_t* __restrict__ w;   // the limb's twiddles (psi or psi^-1)
  const uint32_t* __restrict__ ws;  // and their Shoup quotients
  uint32_t q;
  uint32_t ni, ni_shoup;            // N^-1 (inverse only)
  uint32_t rank;                    // CTA rank in the cluster
};

// ----------------------------------------------------------------------------
// Local passes: stages S0 .. S0+R-1 of the transform of this CTA's 2^LOGNL
// words (global stages log2(C) + S0 ..).  Group gid = (hi, lo) holds words
// base + k 2^A, A = LOGNL - S0 - R, base = hi 2^(A+R) + lo; its twiddles
// start at g = (C + rank) 2^S0 + hi, the table index of its first stage.
// ----------------------------------------------------------------------------

template <int LOGNL, int C, int S0, int R, bool FWD, bool SCALE>
__device__ __forceinline__ void local_pass(uint32_t* a, const Row& r) {
  constexpr int A = LOGNL - S0 - R;
  constexpr int kGroups = 1 << (LOGNL - R);
  constexpr int T = threads_for(LOGNL);
#pragma unroll 1
  for (int gid = threadIdx.x; gid < kGroups; gid += T) {
    const uint32_t hi = static_cast<uint32_t>(gid) >> A;
    const uint32_t lo = static_cast<uint32_t>(gid) & ((1u << A) - 1);
    uint32_t* p = a + phys((hi << (A + R)) | lo);
    uint32_t x[1 << R], t[1 << R], ts[1 << R];
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) x[k] = p[phys(k << A)];
    const uint32_t g = ((C + r.rank) << S0) + hi;
    load_twiddles<R>(t, r.w, g);
    load_twiddles<R>(ts, r.ws, g);
    if constexpr (FWD) {
      fwd_radix<R>(x, t, ts, r.q);
    } else {
      bwd_radix<R>(x, t, ts, r.q);
    }
    if constexpr (SCALE) {
#pragma unroll
      for (int k = 0; k < (1 << R); ++k) x[k] = shoup_mul(x[k], r.ni, r.ni_shoup, r.q);
    }
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) p[phys(k << A)] = x[k];
  }
}

// Forward local passes from local stage S0 on, each closed by a barrier.
template <int LOGNL, int C, int S0 = 0>
__device__ __forceinline__ void fwd_local(uint32_t* a, const Row& r) {
  if constexpr (S0 < LOGNL) {
    constexpr int R = pass_from(LOGNL, S0);
    local_pass<LOGNL, C, S0, R, true, false>(a, r);
    __syncthreads();
    fwd_local<LOGNL, C, S0 + R>(a, r);
  }
}

// Inverse local passes, last stage first, down to local stage 0.  Without a
// cluster the pass holding stage 0 also applies N^-1.
template <int LOGNL, int C, int END = LOGNL>
__device__ __forceinline__ void bwd_local(uint32_t* a, const Row& r) {
  if constexpr (END > 0) {
    constexpr int R = pass_to(LOGNL, END);
    local_pass<LOGNL, C, END - R, R, false, C == 1 && END == R>(a, r);
    __syncthreads();
    bwd_local<LOGNL, C, END - R>(a, r);
  }
}

// ----------------------------------------------------------------------------
// The radix-C pass across the cluster: global stages 0 .. log2(C)-1 on the
// words b + k N/C, k < C, for this CTA's N/C^2 bases b.  Word k lies at b in
// CTA k's chunk (part[k], its shared memory mapped into this CTA's).
// ----------------------------------------------------------------------------

// Forward (C > 1).  From device memory (`src` is the row) or, when src is
// null, from the chunks; to the chunks.
template <int LOGNL, int C>
__device__ __forceinline__ void fwd_cross(uint32_t* const (&part)[C],
                                          const uint32_t* __restrict__ src, const Row& r) {
  constexpr int LC = log2i(C);
  constexpr int NL = 1 << LOGNL;
  constexpr int T = threads_for(LOGNL);
  uint32_t t[C], ts[C];
  load_twiddles<LC>(t, r.w, 1);
  load_twiddles<LC>(ts, r.ws, 1);
  const uint32_t first = r.rank * (NL / C);
#pragma unroll 1
  for (uint32_t b = first + threadIdx.x; b < first + NL / C; b += T) {
    uint32_t x[C];
    const uint32_t pb = phys(b);
#pragma unroll
    for (int k = 0; k < C; ++k) x[k] = src ? __ldg(src + b + k * NL) : part[k][pb];
    fwd_radix<LC>(x, t, ts, r.q);
#pragma unroll
    for (int k = 0; k < C; ++k) part[k][pb] = x[k];
  }
}

// Inverse, with N^-1.  To the chunks or, when dst is not null, reduced to
// [0, q) into device memory (`dst` is the row).
template <int LOGNL, int C>
__device__ __forceinline__ void bwd_cross(uint32_t* const (&part)[C],
                                          uint32_t* __restrict__ dst, const Row& r) {
  constexpr int LC = log2i(C);
  constexpr int NL = 1 << LOGNL;
  constexpr int T = threads_for(LOGNL);
  uint32_t t[C], ts[C];
  load_twiddles<LC>(t, r.w, 1);
  load_twiddles<LC>(ts, r.ws, 1);
  const uint32_t first = r.rank * (NL / C);
#pragma unroll 1
  for (uint32_t b = first + threadIdx.x; b < first + NL / C; b += T) {
    uint32_t x[C];
    const uint32_t pb = phys(b);
#pragma unroll
    for (int k = 0; k < C; ++k) x[k] = part[k][pb];
    bwd_radix<LC>(x, t, ts, r.q);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const uint32_t v = shoup_mul(x[k], r.ni, r.ni_shoup, r.q);   // [0, 2q)
      if (dst) {
        dst[b + k * NL] = csub(v, r.q);
      } else {
        part[k][pb] = v;
      }
    }
  }
}

template <int C>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (C > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// ----------------------------------------------------------------------------
// Kernels: one row of 2^LOGN words over a cluster of C CTAs (C = 1: one CTA),
// `steps` transforms; steps = 1 is ntt_fwd / ntt_bwd.
// ----------------------------------------------------------------------------

template <int LOGN, int C>
__device__ __forceinline__ Row row_state(const uint32_t* w, const uint32_t* ws,
                                         const uint32_t* moduli, int limbs, size_t row) {
  const int limb = static_cast<int>(row % limbs);
  Row r;
  r.q = moduli[limb];
  r.w = w + (static_cast<size_t>(limb) << LOGN);
  r.ws = ws + (static_cast<size_t>(limb) << LOGN);
  r.ni = r.ni_shoup = 0;
  r.rank = 0;
  if constexpr (C > 1) r.rank = cg::this_cluster().block_rank();
  return r;
}

template <int C>
__device__ __forceinline__ void map_parts(uint32_t* (&part)[C], uint32_t* a) {
#pragma unroll
  for (int k = 0; k < C; ++k) {
    if constexpr (C > 1) {
      part[k] = cg::this_cluster().map_shared_rank(a, k);
    } else {
      part[k] = a;
    }
  }
}

template <int LOGN, int C>
__global__ void __launch_bounds__(kMaxThreads, 2)
ntt_fwd_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
               const uint32_t* __restrict__ psi, const uint32_t* __restrict__ psi_shoup,
               const uint32_t* __restrict__ moduli, int limbs, int steps) {
  constexpr int LOGNL = LOGN - log2i(C);
  constexpr int NL = 1 << LOGNL;
  constexpr int T = threads_for(LOGNL);
  extern __shared__ uint32_t a[];
  const size_t row = blockIdx.x / C;
  const Row r = row_state<LOGN, C>(psi, psi_shoup, moduli, limbs, row);
  uint32_t* part[C];
  map_parts<C>(part, a);

  if constexpr (C > 1) {
    cg::this_cluster().sync();  // every CTA has started
    fwd_cross<LOGNL, C>(part, in + (row << LOGN), r);
  } else {
    // A plain copy, which the compiler unrolls: several loads in flight a
    // thread (fwd_cross's loop, kept rolled for its registers, has one).
    const uint32_t* src = in + (row << LOGN);
    for (int j = threadIdx.x; j < NL; j += T) a[phys(j)] = __ldg(src + j);
  }
  cluster_sync<C>();
  for (int step = 0;;) {
    fwd_local<LOGNL, C>(a, r);
    if (++step == steps) break;
    if constexpr (C > 1) {
      cluster_sync<C>();
      fwd_cross<LOGNL, C>(part, nullptr, r);
      cluster_sync<C>();
    }
  }
  const uint32_t two_q = 2 * r.q;
  uint32_t* dst = out + (row << LOGN) + r.rank * NL;
  for (int j = threadIdx.x; j < NL; j += T) dst[j] = csub(csub(a[phys(j)], two_q), r.q);
}

template <int LOGN, int C>
__global__ void __launch_bounds__(kMaxThreads, 2)
ntt_bwd_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
               const uint32_t* __restrict__ ipsi, const uint32_t* __restrict__ ipsi_shoup,
               const uint32_t* __restrict__ moduli, const uint32_t* __restrict__ ninv,
               const uint32_t* __restrict__ ninv_shoup, int limbs, int steps) {
  constexpr int LOGNL = LOGN - log2i(C);
  constexpr int NL = 1 << LOGNL;
  constexpr int T = threads_for(LOGNL);
  extern __shared__ uint32_t a[];
  const size_t row = blockIdx.x / C;
  Row r = row_state<LOGN, C>(ipsi, ipsi_shoup, moduli, limbs, row);
  r.ni = ninv[row % limbs];
  r.ni_shoup = ninv_shoup[row % limbs];
  uint32_t* part[C];
  map_parts<C>(part, a);

  const uint32_t* src = in + (row << LOGN) + r.rank * NL;
  for (int j = threadIdx.x; j < NL; j += T) a[phys(j)] = __ldg(src + j);
  __syncthreads();
  uint32_t* dst = out + (row << LOGN);
  for (int step = 0;;) {
    bwd_local<LOGNL, C>(a, r);
    const bool last = ++step == steps;
    if constexpr (C > 1) {
      cluster_sync<C>();
      bwd_cross<LOGNL, C>(part, last ? dst : nullptr, r);
      cluster_sync<C>();   // the chunks are read by other CTAs until here
    }
    if (last) break;
  }
  if constexpr (C == 1) {
    for (int j = threadIdx.x; j < NL; j += T) dst[j] = csub(a[phys(j)], r.q);
  }
}

// ----------------------------------------------------------------------------
// Launch.
// ----------------------------------------------------------------------------

using FwdKernel = void (*)(const uint32_t*, uint32_t*, const uint32_t*, const uint32_t*,
                           const uint32_t*, int, int);
using BwdKernel = void (*)(const uint32_t*, uint32_t*, const uint32_t*, const uint32_t*,
                           const uint32_t*, const uint32_t*, const uint32_t*, int, int);

// This library's kernels: the ones of N = 2^MFHE_NTT_LOGN, one a cluster
// size (ops/ntt_cuda.py builds one library for each N, all in parallel).
template <int C>
constexpr bool built() {
  return MFHE_NTT_LOGN >= (C == 1 ? kMinLogN : kMinClusterLogN);
}

template <int C>
FwdKernel fwd_kernel() {
  if constexpr (built<C>()) {
    return ntt_fwd_kernel<MFHE_NTT_LOGN, C>;
  } else {
    return nullptr;
  }
}

template <int C>
BwdKernel bwd_kernel() {
  if constexpr (built<C>()) {
    return ntt_bwd_kernel<MFHE_NTT_LOGN, C>;
  } else {
    return nullptr;
  }
}

template <typename Kernel>
Kernel pick(Kernel (*const by_c[4])(), int logn, int c) {
  const int lc = log2i(c);
  if (logn != MFHE_NTT_LOGN || c < 1 || c > 8 || (1 << lc) != c) return nullptr;
  return by_c[lc]();
}

// Shared memory a kernel may use is raised above 48 KB once per kernel and
// device, not at every launch.
std::atomic<uint64_t> configured[2][4];

cudaError_t configure(const void* kernel, bool fwd, int c, size_t smem, int dev) {
  const uint64_t bit = 1ull << (dev & 63);
  std::atomic<uint64_t>& done = configured[fwd][log2i(c)];
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename Kernel, typename... Args>
cudaError_t launch_on(Kernel kernel, bool fwd, int rows, int logn, int c, int dev,
                      void* stream, Args... args) {
  const int lognl = logn - log2i(c);
  const size_t smem = smem_for(lognl);
  cudaError_t err = configure(reinterpret_cast<const void*>(kernel), fwd, c, smem, dev);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * c, 1, 1);
  cfg.blockDim = dim3(threads_for(lognl), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = c > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Launch on device `dev` (the calling thread's device is switched to it for
// the launch and back) and `stream`, a stream of that device.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, bool fwd, int rows, int logn, int c, int dev, void* stream,
           Args... args) {
  if (kernel == nullptr || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_on(kernel, fwd, rows, logn, c, dev, stream, args...);
  if (prev != dev) cudaSetDevice(prev);
  return static_cast<int>(err);
}

}  // namespace

// C entry points, bound with ctypes (matrix_fhe_tpu_torch/ops/ntt_cuda.py).
// Pointers are device pointers of int32 tensors whose words are read as
// uint32; `rows` is the number of length-2^logn rows; `k` >= 1 is the number
// of chained transforms; `cluster` (1, 2, 4 or 8) the CTAs a row is split
// over; `device` the CUDA device of the pointers and `stream` a stream of it.
// The return value is the CUDA error of the launch (0 on success;
// cudaErrorInvalidValue for a size or cluster with no kernel in this
// library: each library holds the kernels of one N).

extern "C" int mfhe_ntt_chain_fwd(const void* in, void* out, const void* psi,
                                  const void* psi_shoup, const void* moduli,
                                  int rows, int limbs, int logn, int k, int cluster,
                                  int device, void* stream) {
  FwdKernel (*const by_c[4])() = {fwd_kernel<1>, fwd_kernel<2>, fwd_kernel<4>, fwd_kernel<8>};
  return launch(pick(by_c, logn, cluster), true, rows, logn, cluster, device, stream,
                static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
                static_cast<const uint32_t*>(psi), static_cast<const uint32_t*>(psi_shoup),
                static_cast<const uint32_t*>(moduli), limbs, k);
}

extern "C" int mfhe_ntt_chain_bwd(const void* in, void* out, const void* ipsi,
                                  const void* ipsi_shoup, const void* moduli,
                                  const void* ninv, const void* ninv_shoup,
                                  int rows, int limbs, int logn, int k, int cluster,
                                  int device, void* stream) {
  BwdKernel (*const by_c[4])() = {bwd_kernel<1>, bwd_kernel<2>, bwd_kernel<4>, bwd_kernel<8>};
  return launch(pick(by_c, logn, cluster), false, rows, logn, cluster, device, stream,
                static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
                static_cast<const uint32_t*>(ipsi), static_cast<const uint32_t*>(ipsi_shoup),
                static_cast<const uint32_t*>(moduli), static_cast<const uint32_t*>(ninv),
                static_cast<const uint32_t*>(ninv_shoup), limbs, k);
}
