// Negacyclic NTT / inverse NTT over 64-bit RNS residues (moduli below
// 2^61 + 2^55, the wide path's range; the u64 rings stop at 2^61),
// for Hopper (sm_90a): kernel B4 of the port.
//
// Replaces the TPU's wide NTT, matrix_fhe_tpu/ops/wide_ntt.py:_transform
// (ntt_fwd / ntt_bwd), which is not a Pallas kernel but XLA int8 matmuls
// over 7 digit planes of a centered int32 pair: the TPU has no 64-bit (nor
// widening 32x32) multiplier.  This card has a 64-bit multiply-high
// (__umul64hi), so a residue is one 64-bit word and the transform is the
// butterfly NTT of the port's u64 ring (ops/rings.py:_ntt_standard /
// _intt_standard), bit for bit: each row of an [..., L, N] tensor (limb =
// row mod L) is transformed under its modulus q, the output is in the
// reference's bit-reversed order (ring/ntt.go) and canonical in [0, q).
// 16 <= N <= 2^16.
//
// What bounds it on this card: a limb-transform reads and writes N * 8 bytes
// (128 KB each way at N = 2^14) and needs its N - 1 twiddles; it runs
// log2(N) stages of N/2 butterflies, each a Shoup product of 64-bit words
// (15 32-bit multiply-adds on the FMA pipe).  At the few rows of a step the
// bytes and the multiplies are a few us of the card, and a launch is bound
// by its chain of latencies on the few SMs of one row: the launch itself,
// the row's load and store, and the passes, whose time halves each time C
// doubles (tools/ntt_cluster_sweep.py --b4 on an H100 at 700 W, one row of
// 2^14: an empty launch ~2 us, the passes ~31 / 18 / 8 / 4 us at
// C = 1 / 2 / 4 / 8, so the SMs of a row issue at a fraction of their rate
// on dependent 64-bit multiplies).  At many rows the same passes fill the
// card and the instructions bound it.
//
// What the design does about it:
//   * Radix passes in registers of up to R = 3 stages (8 words a group, a
//     thread a group: 12 butterflies).  Forward: Cooley-Tukey over the
//     bit-reversed psi powers; inverse: Gentleman-Sande over the psi^-1
//     powers, then N^-1.
//   * Each twiddle beside its Shoup quotient in one 16-byte pair (the
//     ring's psi2 / ipsi2, ops/rings.py), one vector load a twiddle; a
//     thread fetches the twiddles of its next pass before the current
//     pass's stores and barrier, and those of its first pass at entry, so
//     the table's latency overlaps the row's load and the passes (where a
//     thread's share of a pass is at most 16 words: N / C <= 2^12).  A
//     radix-8 pass issues 7 table loads, not 14.
//   * The row goes between device memory and registers inside a pass where
//     a warp's accesses stay coalesced: the forward radix-C pass across the
//     cluster reads it, and without a cluster the forward's first local pass
//     reads it (where a thread takes at most two groups, so its loads are
//     issued together) and the inverse's last one writes it.  The other
//     side of each (the forward's last pass, the inverse's first: a
//     thread's 2^R words consecutive) goes through shared memory and one
//     coalesced loop.
//   * One row a CTA or a thread-block cluster of C = 2, 4, 8 or 16 CTAs
//     (16 non-portable), each holding N/C words in dynamic shared memory,
//     padded by a word every 16 (a half-warp's 64-bit accesses fall in 16
//     distinct 8-byte slots in every pass but the one whose groups' words
//     are 8 apart, 2-way there; a pad every 32 conflicted in two passes).  The first log2(C) forward stages (the last inverse ones)
//     run as one radix-C pass across the cluster through distributed shared
//     memory; the forward pass's global loads overlap the cluster barrier
//     that tells a CTA the others have started (split arrive / wait).  A CTA
//     holds at most 2^14 words (139 KB), so N = 2^15 needs C >= 2 and 2^16
//     C >= 4; ops/ntt64_cuda.py:geometry picks C from the rows, by the
//     sweep's measurements.
//   * Values stay lazily in [0, 4q) (forward) or [0, 2q) (inverse) between
//     stages, and every sum a butterfly or a CI fold forms is below 4q:
//     4q < 2^64 for q < 2^62, so for the wide path's moduli up to
//     2^61 + 2^55.  Every compare is unsigned (`csub`, a min of unsigned
//     words).  Products are Shoup products with __umul64hi, exact in
//     unsigned 64-bit arithmetic for w < q < 2^62; one reduction to [0, q)
//     at the store.
//
// The CI mode (entries mfhe_ntt64_ci_fwd / _bwd): the NTT of the
// conjugate-invariant ring Z_q[X + X^-1]/(X^2N + 1), which replaces
// matrix_fhe_tpu/ops/rings.py:_ntt_ci / _intt_ci (XLA ops): a fold
// y[j] = x[j] - F x[N - j] (j >= 1) before the standard stages (over the
// ring's re-indexed table of 4N-th roots, ops/rings.py:_ci_kernel_tables),
// and after the inverse stages out[j] = (2N)^-1 (y[j] - F y[N - j]),
// out[0] = (2N)^-1 2 y[0], with F = psi^N forward and psi^-N inverse.  The
// fold is fused into the load (forward) and the store (inverse), so a CI
// transform is one launch.  Both words of a fold are read in one thread:
// without a cluster a thread takes words j and N - j (through shared
// memory); with one, it takes the bases b and NL - b of the radix-C pass,
// whose words b + k NL and (NL - b) + (C - 1 - k) NL are each other's
// partners (for b = 0, k NL and (C - k) NL), so no exchange beyond the
// radix-C pass's own is needed.  The standard mode's kernels are compiled
// without the CI code.
//
// All arithmetic is unsigned: signed overflow is undefined in CUDA C.
// The kernels allocate nothing and launch on the caller's stream.

#include <atomic>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#ifndef MFHE_NTT_LOGN
#error "build with -DMFHE_NTT_LOGN=<log2 N>, 4 to 16"
#endif

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;
// A table word w beside its Shoup quotient floor(w 2^64 / q).
using Pair = ulonglong2;

constexpr int kMaxThreads = 256;
constexpr int kMinLogN = 4;
constexpr int kMaxLogN = 16;
static_assert(MFHE_NTT_LOGN >= kMinLogN && MFHE_NTT_LOGN <= kMaxLogN, "4 <= log2 N <= 16");
// Rows split over a cluster only from N = 2^10 on.
constexpr int kMinClusterLogN = 10;
// The largest local chunk one CTA holds (139 KB of 64-bit words, padded).
constexpr int kMaxLocalLogN = 14;
constexpr int kMaxCluster = 16;

// ----------------------------------------------------------------------------
// Geometry, all compile-time for a (log2 N, C) kernel.
// ----------------------------------------------------------------------------

__host__ __device__ constexpr int log2i(int c) { return c <= 1 ? 0 : 1 + log2i(c / 2); }

// Shared-memory word of local word j: one pad word every 16.  For x, y with
// disjoint bits phys(x | y) = phys(x) + phys(y).
__host__ __device__ constexpr uint32_t phys(uint32_t j) { return j + (j >> 4); }

// Threads of a CTA holding 2^lognl words: one a group of 8, 32 to 256.
__host__ __device__ constexpr int threads_for(int lognl) { return 1 << (lognl - 3 + (lognl < 8) * (8 - lognl) - (lognl > 11) * (lognl - 11)); }

constexpr size_t smem_for(int lognl) {
  return sizeof(u64) * phys(1u << lognl);
}

// The local stages 0 .. lognl-1 in P = ceil(lognl / 3) passes of at most 3
// stages, as even as possible, the shorter ones first: 11 = 2 + 3 + 3 + 3,
// 14 = 2 + 3 + 3 + 3 + 3.  (Radix-16 passes, 11 = 3 + 4 + 4, were 15-70%
// slower on the H100: a CTA's 16-word groups leave half its threads idle,
// and at many rows the registers they hold cut the CTAs an SM runs.)
// Stages of the pass that starts at local stage s0, and of the one that
// ends at stage `end`.
__host__ __device__ constexpr int pass_count(int lognl) { return (lognl + 2) / 3; }
__host__ __device__ constexpr int longer_from(int lognl) { return (pass_count(lognl) - lognl % pass_count(lognl)) * (lognl / pass_count(lognl)); }
__host__ __device__ constexpr int pass_from(int lognl, int s0) { return lognl / pass_count(lognl) + (s0 >= longer_from(lognl)); }
__host__ __device__ constexpr int pass_to(int lognl, int end) { return lognl / pass_count(lognl) + (end > longer_from(lognl)); }

// Groups of 2^r words a thread takes in a pass of r stages.
__host__ __device__ constexpr int iters_for(int lognl, int r) { return ((1 << (lognl - r)) + threads_for(lognl) - 1) / threads_for(lognl); }

// A thread holds a pass's twiddles in registers, fetched ahead of the pass,
// where its share of the pass is at most 16 words.
__host__ __device__ constexpr bool held(int lognl, int r) { return (iters_for(lognl, r) << r) <= 16; }

// ----------------------------------------------------------------------------
// Arithmetic.
// ----------------------------------------------------------------------------

// w * x mod q in [0, 2q), for any x < 2^64, w < q < 2^62 and
// w_shoup = floor(w * 2^64 / q).  The true value is below 2q < 2^64, so the
// wrapping unsigned multiply-subtract returns it exactly.
__device__ __forceinline__ u64 shoup_mul(u64 x, u64 w, u64 w_shoup, u64 q) {
  return w * x - __umul64hi(w_shoup, x) * q;
}

// x - m if x >= m, else x (the wrapped difference is larger than x).
__device__ __forceinline__ u64 csub(u64 x, u64 m) {
  return min(x, x - m);
}

// Cooley-Tukey: (u, v) -> (u + w v, u - w v).  In and out: [0, 4q).
__device__ __forceinline__ void ct_butterfly(u64& u, u64& v, Pair w, u64 q, u64 two_q) {
  const u64 a = csub(u, two_q);                 // [0, 2q)
  const u64 b = shoup_mul(v, w.x, w.y, q);      // [0, 2q)
  u = a + b;
  v = a + two_q - b;
}

// Gentleman-Sande: (u, v) -> (u + v, w (u - v)).  In and out: [0, 2q).
__device__ __forceinline__ void gs_butterfly(u64& u, u64& v, Pair w, u64 q, u64 two_q) {
  const u64 s = csub(u + v, two_q);
  v = shoup_mul(u + two_q - v, w.x, w.y, q);
  u = s;
}

// The 2^R - 1 twiddles of a group at pass-local stage d = 0 .. R-1 are the
// 2^d consecutive table pairs from g 2^d; they go to t[2^d + p].
template <int R>
__device__ __forceinline__ void load_twiddles(Pair (&t)[1 << R], const Pair* __restrict__ w,
                                              uint32_t g) {
#pragma unroll
  for (int d = 0; d < R; ++d) {
#pragma unroll
    for (int p = 0; p < (1 << d); ++p) t[(1 << d) + p] = __ldg(w + (g << d) + p);
  }
}

// R stages on the 2^R words x[k] = word base + k * stride of a group: stage
// d pairs k and k + 2^(R-1-d) with twiddle t[2^d + (k >> (R - d))].
template <int R>
__device__ __forceinline__ void fwd_radix(u64 (&x)[1 << R], const Pair (&t)[1 << R], u64 q) {
  const u64 two_q = 2 * q;
#pragma unroll
  for (int d = 0; d < R; ++d) {
    const int half = 1 << (R - 1 - d);
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) {
      if (k & half) continue;
      ct_butterfly(x[k], x[k + half], t[(1 << d) + (k >> (R - d))], q, two_q);
    }
  }
}

template <int R>
__device__ __forceinline__ void bwd_radix(u64 (&x)[1 << R], const Pair (&t)[1 << R], u64 q) {
  const u64 two_q = 2 * q;
#pragma unroll
  for (int d = R - 1; d >= 0; --d) {
    const int half = 1 << (R - 1 - d);
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) {
      if (k & half) continue;
      gs_butterfly(x[k], x[k + half], t[(1 << d) + (k >> (R - d))], q, two_q);
    }
  }
}

// The per-row state every pass needs.
struct Row {
  const Pair* __restrict__ w;  // the limb's twiddles (psi or psi^-1) and quotients
  u64 q;
  u64 ni, ni_shoup;            // N^-1 (inverse only); (2N)^-1 in the CI mode
  u64 f, f_shoup;              // the CI mode's fold factor psi^N (psi^-N inverse)
  uint32_t rank;               // CTA rank in the cluster
};

// ----------------------------------------------------------------------------
// Local passes: stages S0 .. S0+R-1 of the transform of this CTA's 2^LOGNL
// words (global stages log2(C) + S0 ..).  Group gid = (hi, lo) holds words
// base + k 2^A, A = LOGNL - S0 - R, base = hi 2^(A+R) + lo; its twiddles
// start at g = (C + rank) 2^S0 + hi, the table index of its first stage.
// Thread t takes the groups t, t + T, ...
// ----------------------------------------------------------------------------

template <int LOGNL, int S0, int R>
struct Pass {
  static constexpr int A = LOGNL - S0 - R;
  static constexpr int G = 1 << (LOGNL - R);
  static constexpr int T = threads_for(LOGNL);
  static constexpr int IT = iters_for(LOGNL, R);
  static constexpr bool HELD = held(LOGNL, R);
  static_assert(!HELD || IT <= 2, "held twiddles are indexed by an unrolled loop");
};

// A thread's twiddles of a pass, fetched ahead of it where held (else empty).
template <int LOGNL, int S0, int R>
struct Twiddles {
  using P = Pass<LOGNL, S0, R>;
  Pair t[P::HELD ? P::IT : 1][P::HELD ? (1 << R) : 1];
};

template <int LOGNL, int C, int S0, int R>
__device__ __forceinline__ void fetch(Twiddles<LOGNL, S0, R>& tw, const Row& r) {
  using P = Pass<LOGNL, S0, R>;
  if constexpr (P::HELD) {
#pragma unroll
    for (int i = 0; i < P::IT; ++i) {
      const uint32_t gid = threadIdx.x + i * P::T;
      if (P::G % P::T == 0 || gid < P::G) {
        load_twiddles<R>(tw.t[i], r.w, ((C + r.rank) << S0) + (gid >> P::A));
      }
    }
  }
}

// Where a pass reads and writes its words: shared memory, or the row in
// device memory (the forward's first pass reads it as it is, the inverse's
// last pass writes it reduced to [0, q); both only without a cluster).
enum Io { kShared, kGlobal };

// One local pass.  `then()` runs after the arithmetic of the thread's last
// group, before its stores (the next pass's twiddle fetch).
template <int LOGNL, int C, int S0, int R, bool FWD, Io IN, Io OUT, bool SCALE, class Then>
__device__ __forceinline__ void local_pass(u64* a, const u64* __restrict__ src,
                                           u64* __restrict__ dst, const Row& r,
                                           const Twiddles<LOGNL, S0, R>& tw, Then&& then) {
  using P = Pass<LOGNL, S0, R>;
  constexpr int A = P::A;
  static_assert(!(FWD && OUT == kGlobal), "the forward's last pass writes shared memory");
#pragma unroll (P::IT <= 2 ? P::IT : 1)
  for (int i = 0; i < P::IT; ++i) {
    const uint32_t gid = threadIdx.x + i * P::T;
    if (P::G % P::T != 0 && gid >= P::G) {
      then();
      break;
    }
    const uint32_t hi = gid >> A;
    const uint32_t base = (hi << (A + R)) | (gid & ((1u << A) - 1));
    u64 x[1 << R];
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) {
      x[k] = IN == kGlobal ? __ldg(src + base + (k << A)) : a[phys(base) + phys(k << A)];
    }
    Pair t[1 << R];
    if constexpr (P::HELD) {
#pragma unroll
      for (int k = 1; k < (1 << R); ++k) t[k] = tw.t[P::HELD ? i : 0][P::HELD ? k : 0];
    } else {
      load_twiddles<R>(t, r.w, ((C + r.rank) << S0) + hi);
    }
    if constexpr (FWD) {
      fwd_radix<R>(x, t, r.q);
    } else {
      bwd_radix<R>(x, t, r.q);
    }
    if constexpr (SCALE) {
#pragma unroll
      for (int k = 0; k < (1 << R); ++k) x[k] = shoup_mul(x[k], r.ni, r.ni_shoup, r.q);
    }
    if (i == P::IT - 1) then();
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) {
      if constexpr (OUT == kGlobal) {
        dst[base + (k << A)] = csub(x[k], r.q);
      } else {
        a[phys(base) + phys(k << A)] = x[k];
      }
    }
  }
}

struct Nothing {
  __device__ void operator()() const {}
};

// Forward local passes from local stage S0 on, each closed by a barrier;
// the first reads from IN, every one writes shared memory.
template <int LOGNL, int C, int S0, Io IN>
__device__ __forceinline__ void fwd_local(u64* a, const u64* src, const Row& r,
                                          const Twiddles<LOGNL, S0, pass_from(LOGNL, S0)>& tw) {
  constexpr int R = pass_from(LOGNL, S0);
  if constexpr (S0 + R == LOGNL) {
    local_pass<LOGNL, C, S0, R, true, IN, kShared, false>(a, src, nullptr, r, tw, Nothing{});
    __syncthreads();
  } else {
    constexpr int R2 = pass_from(LOGNL, S0 + R);
    Twiddles<LOGNL, S0 + R, R2> next;
    local_pass<LOGNL, C, S0, R, true, IN, kShared, false>(
        a, src, nullptr, r, tw, [&] { fetch<LOGNL, C, S0 + R, R2>(next, r); });
    __syncthreads();
    fwd_local<LOGNL, C, S0 + R, kShared>(a, src, r, next);
  }
}

// Inverse local passes, last stage first, down to local stage 0, from
// shared memory; the pass holding stage 0 writes to OUT (scaled by N^-1 if
// SCALE), the others are each closed by a barrier.
template <int LOGNL, int C, int END, Io OUT, bool SCALE>
__device__ __forceinline__ void bwd_local(
    u64* a, u64* dst, const Row& r,
    const Twiddles<LOGNL, END - pass_to(LOGNL, END), pass_to(LOGNL, END)>& tw) {
  constexpr int R = pass_to(LOGNL, END);
  constexpr int S0 = END - R;
  if constexpr (S0 == 0) {
    local_pass<LOGNL, C, 0, R, false, kShared, OUT, SCALE>(a, nullptr, dst, r, tw, Nothing{});
  } else {
    constexpr int R2 = pass_to(LOGNL, S0);
    Twiddles<LOGNL, S0 - R2, R2> next;
    local_pass<LOGNL, C, S0, R, false, kShared, kShared, false>(
        a, nullptr, dst, r, tw, [&] { fetch<LOGNL, C, S0 - R2, R2>(next, r); });
    __syncthreads();
    bwd_local<LOGNL, C, S0, OUT, SCALE>(a, dst, r, next);
  }
}

// ----------------------------------------------------------------------------
// The radix-C pass across the cluster: global stages 0 .. log2(C)-1 on the
// words b + k N/C, k < C, for this CTA's N/C^2 bases b.  Word k lies at b in
// CTA k's chunk (part[k], its shared memory mapped into this CTA's).
// ----------------------------------------------------------------------------

// The cluster barrier in two halves: a CTA arrives at entry and waits before
// its first write into another CTA's shared memory, so every CTA of the
// cluster has started by then, and the global loads run in between.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Forward (C > 1), from device memory (`src` is the row) to the chunks; the
// cluster barrier's wait after this thread's first loads.
template <int LOGNL, int C>
__device__ __forceinline__ void fwd_cross(u64* const (&part)[C], const u64* __restrict__ src,
                                          const Row& r) {
  constexpr int LC = log2i(C);
  constexpr int NL = 1 << LOGNL;
  constexpr int T = threads_for(LOGNL);
  Pair t[C];
  load_twiddles<LC>(t, r.w, 1);
  const uint32_t end = (r.rank + 1) * (NL / C);
  uint32_t b = r.rank * (NL / C) + threadIdx.x;
  u64 x[C];
  if (b < end) {
#pragma unroll
    for (int k = 0; k < C; ++k) x[k] = __ldg(src + b + k * NL);
  }
  cluster_wait();
#pragma unroll 1
  for (; b < end; b += T) {
    fwd_radix<LC>(x, t, r.q);
    const uint32_t pb = phys(b);
#pragma unroll
    for (int k = 0; k < C; ++k) part[k][pb] = x[k];
    if (b + T < end) {
#pragma unroll
      for (int k = 0; k < C; ++k) x[k] = __ldg(src + b + T + k * NL);
    }
  }
}

// Inverse, with N^-1, reduced to [0, q) into device memory (`dst` is the row).
template <int LOGNL, int C>
__device__ __forceinline__ void bwd_cross(u64* const (&part)[C], u64* __restrict__ dst,
                                          const Row& r) {
  constexpr int LC = log2i(C);
  constexpr int NL = 1 << LOGNL;
  constexpr int T = threads_for(LOGNL);
  Pair t[C];
  load_twiddles<LC>(t, r.w, 1);
  const uint32_t first = r.rank * (NL / C);
#pragma unroll 1
  for (uint32_t b = first + threadIdx.x; b < first + NL / C; b += T) {
    u64 x[C];
    const uint32_t pb = phys(b);
#pragma unroll
    for (int k = 0; k < C; ++k) x[k] = part[k][pb];
    bwd_radix<LC>(x, t, r.q);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      dst[b + k * NL] = csub(shoup_mul(x[k], r.ni, r.ni_shoup, r.q), r.q);
    }
  }
}

// The CI mode's fold of word x under partner word y: x - F y, in (0, 3q)
// for x, y < q (forward, on load), or (2N)^-1 (x - F y) in [0, q) for
// x, y < 2q (inverse, on store).
__device__ __forceinline__ u64 fold_load(u64 x, u64 y, const Row& r) {
  return x + 2 * r.q - shoup_mul(y, r.f, r.f_shoup, r.q);
}

__device__ __forceinline__ u64 fold_store(u64 x, u64 y, const Row& r) {
  const u64 v = x + 2 * r.q - shoup_mul(y, r.f, r.f_shoup, r.q);
  return csub(shoup_mul(v, r.ni, r.ni_shoup, r.q), r.q);
}

__device__ __forceinline__ u64 fold_store0(u64 x, const Row& r) {
  return csub(shoup_mul(x + x, r.ni, r.ni_shoup, r.q), r.q);
}

// The bases of the CI mode's cross passes: this CTA's share of the pairs
// (b, NL - b), b <= NL/2 (the last rank also takes NL/2).
template <int LOGNL, int C>
__device__ __forceinline__ uint32_t ci_first(const Row& r) {
  return r.rank * ((1u << LOGNL) / (2 * C));
}

template <int LOGNL, int C>
__device__ __forceinline__ uint32_t ci_last(const Row& r) {
  return (r.rank + 1) * ((1u << LOGNL) / (2 * C)) + (r.rank == C - 1);
}

// Forward, CI mode (C > 1): the fold on load, then the radix-C pass, for
// the pair of bases b and b2 = NL - b; the cluster barrier's wait before
// the first stores.
template <int LOGNL, int C>
__device__ __forceinline__ void fwd_cross_ci(u64* const (&part)[C], const u64* __restrict__ src,
                                             const Row& r) {
  constexpr int LC = log2i(C);
  constexpr int NL = 1 << LOGNL;
  constexpr int T = threads_for(LOGNL);
  Pair t[C];
  load_twiddles<LC>(t, r.w, 1);
  bool waited = false;
#pragma unroll 1
  for (uint32_t b = ci_first<LOGNL, C>(r) + threadIdx.x; b < ci_last<LOGNL, C>(r); b += T) {
    const uint32_t b2 = (NL - b) & (NL - 1);
    u64 xa[C], xb[C], ya[C], yb[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      xa[k] = __ldg(src + b + k * NL);
      xb[k] = __ldg(src + b2 + k * NL);
    }
    if (b == 0) {
      ya[0] = xa[0];
#pragma unroll
      for (int k = 1; k < C; ++k) ya[k] = fold_load(xa[k], xa[C - k], r);
    } else {
#pragma unroll
      for (int k = 0; k < C; ++k) {
        ya[k] = fold_load(xa[k], xb[C - 1 - k], r);
        yb[k] = fold_load(xb[k], xa[C - 1 - k], r);
      }
    }
    fwd_radix<LC>(ya, t, r.q);
    if (!waited) {
      cluster_wait();
      waited = true;
    }
#pragma unroll
    for (int k = 0; k < C; ++k) part[k][phys(b)] = ya[k];
    if (b2 != b) {
      fwd_radix<LC>(yb, t, r.q);
#pragma unroll
      for (int k = 0; k < C; ++k) part[k][phys(b2)] = yb[k];
    }
  }
  if (!waited) cluster_wait();
}

// Inverse, CI mode (C > 1): the radix-C pass for the pair of bases b and
// NL - b, then the fold with (2N)^-1, reduced to [0, q), into device memory.
template <int LOGNL, int C>
__device__ __forceinline__ void bwd_cross_ci(u64* const (&part)[C], u64* __restrict__ dst,
                                             const Row& r) {
  constexpr int LC = log2i(C);
  constexpr int NL = 1 << LOGNL;
  constexpr int T = threads_for(LOGNL);
  Pair t[C];
  load_twiddles<LC>(t, r.w, 1);
#pragma unroll 1
  for (uint32_t b = ci_first<LOGNL, C>(r) + threadIdx.x; b < ci_last<LOGNL, C>(r); b += T) {
    const uint32_t b2 = (NL - b) & (NL - 1);
    u64 ya[C], yb[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      ya[k] = part[k][phys(b)];
      yb[k] = part[k][phys(b2)];
    }
    bwd_radix<LC>(ya, t, r.q);
    if (b == 0) {
      dst[0] = fold_store0(ya[0], r);
#pragma unroll
      for (int k = 1; k < C; ++k) dst[k * NL] = fold_store(ya[k], ya[C - k], r);
      continue;
    }
    if (b2 != b) {
      bwd_radix<LC>(yb, t, r.q);
    } else {
#pragma unroll
      for (int k = 0; k < C; ++k) yb[k] = ya[k];
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
      dst[b + k * NL] = fold_store(ya[k], yb[C - 1 - k], r);
      if (b2 != b) dst[b2 + k * NL] = fold_store(yb[k], ya[C - 1 - k], r);
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
// Kernels: one row of 2^LOGN words over a cluster of C CTAs (C = 1: one CTA).
// ----------------------------------------------------------------------------

template <int LOGN, int C>
__device__ __forceinline__ Row row_state(const Pair* w, const u64* moduli, int limbs,
                                         size_t row) {
  const int limb = static_cast<int>(row % limbs);
  Row r;
  r.q = moduli[limb];
  r.w = w + (static_cast<size_t>(limb) << LOGN);
  r.ni = r.ni_shoup = r.f = r.f_shoup = 0;
  r.rank = 0;
  if constexpr (C > 1) r.rank = cg::this_cluster().block_rank();
  return r;
}

template <int C>
__device__ __forceinline__ void map_parts(u64* (&part)[C], u64* a) {
#pragma unroll
  for (int k = 0; k < C; ++k) {
    if constexpr (C > 1) {
      part[k] = cg::this_cluster().map_shared_rank(a, k);
    } else {
      part[k] = a;
    }
  }
}

template <int LOGN, int C, bool CI>
__global__ void __launch_bounds__(kMaxThreads, 1)
ntt64_fwd_kernel(const u64* __restrict__ in, u64* __restrict__ out, const Pair* __restrict__ psi,
                 const u64* __restrict__ moduli, const u64* __restrict__ fold, int limbs) {
  constexpr int LOGNL = LOGN - log2i(C);
  constexpr int NL = 1 << LOGNL;
  constexpr int T = threads_for(LOGNL);
  extern __shared__ u64 a[];
  if constexpr (C > 1) cluster_arrive();  // this CTA has started
  const size_t row = blockIdx.x / C;
  Row r = row_state<LOGN, C>(psi, moduli, limbs, row);
  const u64* src = in + (row << LOGN);
  u64* dst = out + (row << LOGN) + r.rank * NL;
  if constexpr (CI) {
    r.f = fold[6 * (row % limbs)];
    r.f_shoup = fold[6 * (row % limbs) + 1];
  }
  constexpr int R0 = pass_from(LOGNL, 0);
  Twiddles<LOGNL, 0, R0> tw;
  // the first local pass's twiddles, fetched while the row loads; a cluster
  // of 16's cross pass holds 16 words a thread (32 in the CI mode), so
  // there they are fetched after it, not to spill
  if constexpr (C <= 8) fetch<LOGNL, C, 0, R0>(tw, r);

  if constexpr (C > 1) {
    u64* part[C];
    map_parts<C>(part, a);
    if constexpr (CI) {
      fwd_cross_ci<LOGNL, C>(part, src, r);
    } else {
      fwd_cross<LOGNL, C>(part, src, r);
    }
    if constexpr (C > 8) fetch<LOGNL, C, 0, R0>(tw, r);
    cluster_sync<C>();
    fwd_local<LOGNL, C, 0, kShared>(a, nullptr, r, tw);
  } else if constexpr (CI) {
    // the fold on load, a thread a pair of words j and N - j
    for (int j = threadIdx.x; j <= NL / 2; j += T) {
      const int j2 = (NL - j) & (NL - 1);
      const u64 x1 = __ldg(src + j), x2 = __ldg(src + j2);
      if (j == 0) {
        a[0] = x1;
        continue;
      }
      a[phys(j)] = fold_load(x1, x2, r);
      if (j2 != j) a[phys(j2)] = fold_load(x2, x1, r);
    }
    __syncthreads();
    fwd_local<LOGNL, C, 0, kShared>(a, nullptr, r, tw);
  } else if constexpr (Pass<LOGNL, 0, R0>::IT <= 2) {
    // the first pass reads the row (a thread's words 2^A apart: coalesced)
    fwd_local<LOGNL, C, 0, kGlobal>(a, src, r, tw);
  } else {
    for (int j = threadIdx.x; j < NL; j += T) a[phys(j)] = __ldg(src + j);
    __syncthreads();
    fwd_local<LOGNL, C, 0, kShared>(a, nullptr, r, tw);
  }
  // the store, reduced to [0, q), coalesced
  const u64 two_q = 2 * r.q;
  for (int j = threadIdx.x; j < NL; j += T) dst[j] = csub(csub(a[phys(j)], two_q), r.q);
}

template <int LOGN, int C, bool CI>
__global__ void __launch_bounds__(kMaxThreads, 1)
ntt64_bwd_kernel(const u64* __restrict__ in, u64* __restrict__ out, const Pair* __restrict__ ipsi,
                 const u64* __restrict__ moduli, const u64* __restrict__ ninv,
                 const u64* __restrict__ ninv_shoup, int limbs) {
  constexpr int LOGNL = LOGN - log2i(C);
  constexpr int NL = 1 << LOGNL;
  constexpr int T = threads_for(LOGNL);
  extern __shared__ u64 a[];
  const size_t row = blockIdx.x / C;
  Row r = row_state<LOGN, C>(ipsi, moduli, limbs, row);
  if constexpr (CI) {
    // `ninv` is the fold row: F, its quotient at 2, 3; (2N)^-1 at 4, 5
    const u64* f = ninv + 6 * (row % limbs);
    r.f = f[2];
    r.f_shoup = f[3];
    r.ni = f[4];
    r.ni_shoup = f[5];
  } else {
    r.ni = ninv[row % limbs];
    r.ni_shoup = ninv_shoup[row % limbs];
  }
  constexpr int R0 = pass_to(LOGNL, LOGNL);
  Twiddles<LOGNL, LOGNL - R0, R0> tw;
  fetch<LOGNL, C, LOGNL - R0, R0>(tw, r);
  const u64* src = in + (row << LOGN) + r.rank * NL;
  u64* dst = out + (row << LOGN);
  // the load, coalesced (the first pass's words are a thread's 2^R
  // consecutive ones)
  for (int j = threadIdx.x; j < NL; j += T) a[phys(j)] = __ldg(src + j);
  __syncthreads();

  if constexpr (C > 1) {
    bwd_local<LOGNL, C, LOGNL, kShared, false>(a, nullptr, r, tw);
    u64* part[C];
    map_parts<C>(part, a);
    cluster_sync<C>();
    if constexpr (CI) {
      bwd_cross_ci<LOGNL, C>(part, dst, r);
    } else {
      bwd_cross<LOGNL, C>(part, dst, r);
    }
    cluster_sync<C>();   // the chunks are read by other CTAs until here
  } else if constexpr (CI) {
    bwd_local<LOGNL, C, LOGNL, kShared, false>(a, nullptr, r, tw);
    __syncthreads();
    // the fold on store, a thread a pair of words j and N - j
    for (int j = threadIdx.x; j <= NL / 2; j += T) {
      const int j2 = (NL - j) & (NL - 1);
      const u64 y1 = a[phys(j)], y2 = a[phys(j2)];
      if (j == 0) {
        dst[0] = fold_store0(y1, r);
        continue;
      }
      dst[j] = fold_store(y1, y2, r);
      if (j2 != j) dst[j2] = fold_store(y2, y1, r);
    }
  } else {
    // the last pass writes the row (a thread's words 2^A apart: coalesced)
    bwd_local<LOGNL, C, LOGNL, kGlobal, true>(a, dst, r, tw);
  }
}

// ----------------------------------------------------------------------------
// Launch.
// ----------------------------------------------------------------------------

using FwdKernel = void (*)(const u64*, u64*, const Pair*, const u64*, const u64*, int);
using BwdKernel = void (*)(const u64*, u64*, const Pair*, const u64*, const u64*, const u64*, int);

// This library's kernels: the ones of N = 2^MFHE_NTT_LOGN, one a cluster
// size whose chunk fits a CTA (ops/ntt64_cuda.py builds one library for
// each N), in each mode.
template <int C>
constexpr bool built() {
  return MFHE_NTT_LOGN >= (C == 1 ? kMinLogN : kMinClusterLogN) &&
         MFHE_NTT_LOGN - log2i(C) <= kMaxLocalLogN;
}

template <int C, bool CI>
FwdKernel fwd_kernel() {
  if constexpr (built<C>()) {
    return ntt64_fwd_kernel<MFHE_NTT_LOGN, C, CI>;
  } else {
    return nullptr;
  }
}

template <int C, bool CI>
BwdKernel bwd_kernel() {
  if constexpr (built<C>()) {
    return ntt64_bwd_kernel<MFHE_NTT_LOGN, C, CI>;
  } else {
    return nullptr;
  }
}

constexpr int kClusterSizes = log2i(kMaxCluster) + 1;

template <typename Kernel>
Kernel pick(Kernel (*const by_c[kClusterSizes])(), int logn, int c) {
  const int lc = log2i(c);
  if (logn != MFHE_NTT_LOGN || c < 1 || c > kMaxCluster || (1 << lc) != c) return nullptr;
  return by_c[lc]();
}

// Shared memory a kernel may use is raised above 48 KB (and a cluster of 16
// allowed) once per kernel and device, not at every launch.
std::atomic<uint64_t> configured[2][2][kClusterSizes];

cudaError_t configure(const void* kernel, bool fwd, bool ci, int c, size_t smem, int dev) {
  const uint64_t bit = 1ull << (dev & 63);
  std::atomic<uint64_t>& done = configured[fwd][ci][log2i(c)];
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && c > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename Kernel, typename... Args>
cudaError_t launch_on(Kernel kernel, bool fwd, bool ci, int rows, int logn, int c, int dev,
                      void* stream, Args... args) {
  const int lognl = logn - log2i(c);
  const size_t smem = smem_for(lognl);
  cudaError_t err = configure(reinterpret_cast<const void*>(kernel), fwd, ci, c, smem, dev);
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
int launch(Kernel kernel, bool fwd, bool ci, int rows, int logn, int c, int dev, void* stream,
           Args... args) {
  if (kernel == nullptr || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_on(kernel, fwd, ci, rows, logn, c, dev, stream, args...);
  if (prev != dev) cudaSetDevice(prev);
  return static_cast<int>(err);
}

}  // namespace

// C entry points, bound with ctypes (matrix_fhe_tpu_torch/ops/ntt64_cuda.py).
// Pointers are device pointers of int64 tensors whose words are read as
// uint64; the table is the limbs' [L, N, 2] (twiddle, Shoup quotient) pairs;
// `rows` is the number of length-2^logn rows; `cluster` (1, 2, 4, 8 or 16)
// the CTAs a row is split over; `device` the CUDA device of the pointers
// and `stream` a stream of it.  The return value is the CUDA error of the
// launch (0 on success; cudaErrorInvalidValue for a size or cluster with no
// kernel in this library: each library holds the kernels of one N).

extern "C" int mfhe_ntt64_fwd(const void* in, void* out, const void* psi, const void* moduli,
                              int rows, int limbs, int logn, int cluster, int device,
                              void* stream) {
  FwdKernel (*const by_c[kClusterSizes])() = {fwd_kernel<1, false>, fwd_kernel<2, false>,
                                              fwd_kernel<4, false>, fwd_kernel<8, false>,
                                              fwd_kernel<16, false>};
  return launch(pick(by_c, logn, cluster), true, false, rows, logn, cluster, device, stream,
                static_cast<const u64*>(in), static_cast<u64*>(out),
                static_cast<const Pair*>(psi), static_cast<const u64*>(moduli),
                static_cast<const u64*>(nullptr), limbs);
}

extern "C" int mfhe_ntt64_bwd(const void* in, void* out, const void* ipsi, const void* moduli,
                              const void* ninv, const void* ninv_shoup, int rows, int limbs,
                              int logn, int cluster, int device, void* stream) {
  BwdKernel (*const by_c[kClusterSizes])() = {bwd_kernel<1, false>, bwd_kernel<2, false>,
                                              bwd_kernel<4, false>, bwd_kernel<8, false>,
                                              bwd_kernel<16, false>};
  return launch(pick(by_c, logn, cluster), false, false, rows, logn, cluster, device, stream,
                static_cast<const u64*>(in), static_cast<u64*>(out),
                static_cast<const Pair*>(ipsi), static_cast<const u64*>(moduli),
                static_cast<const u64*>(ninv), static_cast<const u64*>(ninv_shoup), limbs);
}

// The CI mode: the same, the table being the CI ring's re-indexed one and
// `fold` its [limbs, 6] row of (value, Shoup quotient) pairs: psi^N,
// psi^-N, (2N)^-1 (ops/rings.py:_ci_kernel_tables).

extern "C" int mfhe_ntt64_ci_fwd(const void* in, void* out, const void* psi, const void* moduli,
                                 const void* fold, int rows, int limbs, int logn, int cluster,
                                 int device, void* stream) {
  FwdKernel (*const by_c[kClusterSizes])() = {fwd_kernel<1, true>, fwd_kernel<2, true>,
                                              fwd_kernel<4, true>, fwd_kernel<8, true>,
                                              fwd_kernel<16, true>};
  return launch(pick(by_c, logn, cluster), true, true, rows, logn, cluster, device, stream,
                static_cast<const u64*>(in), static_cast<u64*>(out),
                static_cast<const Pair*>(psi), static_cast<const u64*>(moduli),
                static_cast<const u64*>(fold), limbs);
}

extern "C" int mfhe_ntt64_ci_bwd(const void* in, void* out, const void* ipsi, const void* moduli,
                                 const void* fold, int rows, int limbs, int logn, int cluster,
                                 int device, void* stream) {
  BwdKernel (*const by_c[kClusterSizes])() = {bwd_kernel<1, true>, bwd_kernel<2, true>,
                                              bwd_kernel<4, true>, bwd_kernel<8, true>,
                                              bwd_kernel<16, true>};
  return launch(pick(by_c, logn, cluster), false, true, rows, logn, cluster, device, stream,
                static_cast<const u64*>(in), static_cast<u64*>(out),
                static_cast<const Pair*>(ipsi), static_cast<const u64*>(moduli),
                static_cast<const u64*>(fold), static_cast<const u64*>(nullptr), limbs);
}
