// The NTT of the 3N ring Z_q[X]/(X^N - X^{N/2} + 1), N = 2^a 3^b, over
// 64-bit RNS residues (moduli below 2^61), for Hopper (sm_90a): kernel B5 of
// the port.
//
// Replaces matrix_fhe_tpu/ops/ntt_3n.py:ntt_fwd / ntt_bwd, which are not
// Pallas kernels but XLA u64 Montgomery mod-matmuls: the TPU's fast unit is
// a matrix unit, so the JAX transform computes each branch's DFT_M as dense
// [R, R] and [C, C] products, M (R + C) multiply-adds.  This card has a
// 64-bit multiply-high (__umul64hi), so here DFT_M is a mixed-radix FFT:
// (M/2) log2-stage butterflies and 3 products a radix-3 butterfly, ~19x
// fewer products at N = 12288.  The result is what the port's plain version
// (ops/ntt_3n.py) computes, bit for bit: every exact decomposition of DFT_M
// over the same omega_M gives the same residues, and every output is
// canonical in [0, q).  With M = N/2 = 2^p 3^b and z = omega^M:
//
//   forward, on load:  a0[j] = (lo[j] + z hi[j]) omega^j
//                      a1[j] = (lo[j] + z^5 hi[j]) omega^-j,  z^5 = 1 - z
//   each branch:       X = DFT_M(a), in place, decimation in frequency: the
//                      p radix-2 stages (Gentleman-Sande), then the b radix-3
//                      stages; X[k] ends at the mixed-radix digit reversal
//                      of k
//   on store:          out[kidx[branch M + position]] = X, kidx composing the
//                      digit reversal with the E-sorted order
//   inverse: the gather through kidx, each stage's inverse last stage first
//   (Cooley-Tukey butterflies, the twiddles and the cube root inverted; the
//   factor M they leave is folded into the untwist), the untwist, and the
//   2x2 CRT solve hi = (u - w) / (z - z^5), lo = u - z hi, in registers.
//
// Tables (ops/ntt_3n.py:kernel_layout): a row a limb of (value, Shoup
// quotient) pairs, read as 16-byte loads: q, z, the cube root of unity and
// (inverse) (z - z^5)^-1, the twists of both branches, then each stage's
// twiddles, the stage of block size Ms from pair 4 + 3M - Ms on.  kidx is
// one int32 array for all limbs.
//
// What bounds it on this card: a (row, limb) transform needs 8 B a word in
// and out plus its limb's tables (24 B a word, read from L2 after the first
// row), and 8 Shoup products a word at N = 12288 (15 multiply-adds each on
// the FMA pipe).  At phase 15's shapes, one to seven rows of N = 12288, both
// bounds are under a microsecond: the launch is bound by latency (global
// loads, barriers, dependent 64-bit multiplies) and by how many SMs it
// occupies.
//
// What the design does about it:
//   * One CTA holds both branches of its words, so the CRT solve needs no
//     exchange, and butterflies run in place: 2M words of shared memory a
//     row (96 KB at N = 12288), padded by a word every 32 against bank
//     conflicts, in radix-8/4/2 and radix-3 groups held in registers
//     (B4's radix-8 groups of 64-bit words fit without spills).
//   * A row splits over a thread-block cluster of C = 2, 4 or 8 CTAs
//     (ops/ntt3n_cuda.py:geometry), so a launch of one row runs on C SMs:
//     the first log2 C stages are one radix-C pass from device memory into
//     the C CTAs' buffers through distributed shared memory (the fold and
//     twist on its load), the inverse's last ones one pass from them into
//     device memory (the untwist and CRT on its store), as B4's cluster
//     pass; the CTA of rank r then holds FFT positions [r M/C, (r+1) M/C)
//     of each branch.
//   * Values stay lazy between stages, in [0, 2q) forward and [0, 4q)
//     inverse (4q < 2^63 for q < 2^61); Shoup products with __umul64hi are
//     exact in unsigned 64-bit arithmetic; one reduction at the store.
//   * Strides are run-time values (one library for all N); a group's block
//     and offset come from a multiply-high by a reciprocal, not a division.
//
// All arithmetic is unsigned: signed overflow is undefined in CUDA C.  The
// kernels allocate nothing and launch on the caller's stream.

#include <atomic>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;
using u32 = uint32_t;
using Pair = ulonglong2;  // (value, Shoup quotient)

constexpr int kMaxThreads = 256;
constexpr int kHeader = 4;       // header pairs of a limb's row
constexpr int kMaxCluster = 8;   // the portable cluster size
// The dynamic shared memory a CTA may hold on sm_90.
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr int log2i(int c) { return c <= 1 ? 0 : 1 + log2i(c / 2); }

// Shared-memory word of local word j: one pad word every 32.
__host__ __device__ constexpr u32 phys(u32 j) { return j + (j >> 5); }

// Words between the two branches' buffers of a CTA holding Q words a branch.
__host__ __device__ constexpr u32 branch_stride(u32 q_local) { return phys(q_local) | 1u; }

// Stages of the local radix-2 pass that starts at local stage s0 of n2:
// ceil(n2 / 3) passes, as even as possible, the shorter first (B4's rule).
__host__ __device__ constexpr int pass_count(int n2) { return (n2 + 2) / 3; }
__host__ __device__ constexpr int longer_from(int n2) {
  return (pass_count(n2) - n2 % pass_count(n2)) * (n2 / pass_count(n2));
}
__host__ __device__ constexpr int pass_from(int n2, int s0) {
  return n2 / pass_count(n2) + (s0 >= longer_from(n2));
}
__host__ __device__ constexpr int pass_to(int n2, int end) {
  return n2 / pass_count(n2) + (end > longer_from(n2));
}

// ----------------------------------------------------------------------------
// Arithmetic.
// ----------------------------------------------------------------------------

// w * x mod q in [0, 2q), for any x < 2^64, w < q < 2^62 and
// w_shoup = floor(w * 2^64 / q).
__device__ __forceinline__ u64 shoup_mul(u64 x, Pair w, u64 q) {
  return w.x * x - __umul64hi(w.y, x) * q;
}

// x - m if x >= m, else x (the wrapped difference is larger than x).
__device__ __forceinline__ u64 csub(u64 x, u64 m) { return min(x, x - m); }

// Gentleman-Sande: (u, v) -> (u + v, w (u - v)).  In and out: [0, 2q).
__device__ __forceinline__ void gs(u64& u, u64& v, Pair w, u64 q) {
  const u64 s = csub(u + v, 2 * q);
  v = shoup_mul(u + 2 * q - v, w, q);
  u = s;
}

// Cooley-Tukey: (u, v) -> (u + w v, u - w v).  In and out: [0, 4q).
__device__ __forceinline__ void ct(u64& u, u64& v, Pair w, u64 q) {
  const u64 a = csub(u, 2 * q);
  const u64 b = shoup_mul(v, w, q);
  u = a + b;
  v = a + 2 * q - b;
}

// x / d for x d < 2^31, with r = ceil(2^31 / d) (d >= 1).
__device__ __forceinline__ u32 udiv(u32 x, u32 r) { return __umulhi(x << 1, r); }
__device__ __forceinline__ u32 recip(u32 d) { return static_cast<u32>(((1ull << 31) + d - 1) / d); }

// ----------------------------------------------------------------------------
// Butterfly groups.  A group of a pass holds the words base + t S (t < its
// radix) of one block; its twiddles depend on its offset jj < S in the
// block alone.  `tab` is the limb's row of pairs; the stage whose blocks
// are ms words long reads from pair kHeader + 3M - ms on.
// ----------------------------------------------------------------------------

__device__ __forceinline__ const Pair* stage_tab(const Pair* tab, u32 m, u32 ms) {
  return tab + (kHeader + 3 * m - ms);
}

// R radix-2 DIF stages, the first of block size ms: sub-stage d pairs k with
// k + 2^(R-1-d) (that bit of k clear) under omega_(ms/2^d)^(jj + S u),
// u = k mod 2^(R-1-d).
template <int R>
__device__ __forceinline__ void dif2(u64 (&x)[1 << R], const Pair* tab, u32 m, u32 ms, u32 jj,
                                     u32 S, u64 q) {
#pragma unroll
  for (int d = 0; d < R; ++d) {
    const int half = 1 << (R - 1 - d);
    const Pair* t = stage_tab(tab, m, ms >> d) + jj;
    Pair w[1 << (R - 1)];
#pragma unroll
    for (int u = 0; u < half; ++u) w[u] = __ldg(t + u * S);
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) {
      if (k & half) continue;
      gs(x[k], x[k + half], w[k & (half - 1)], q);
    }
  }
}

// The inverse of dif2 up to the factor 2^R (inverse twiddles, last sub-stage
// first).
template <int R>
__device__ __forceinline__ void dit2(u64 (&x)[1 << R], const Pair* tab, u32 m, u32 ms, u32 jj,
                                     u32 S, u64 q) {
#pragma unroll
  for (int d = R - 1; d >= 0; --d) {
    const int half = 1 << (R - 1 - d);
    const Pair* t = stage_tab(tab, m, ms >> d) + jj;
    Pair w[1 << (R - 1)];
#pragma unroll
    for (int u = 0; u < half; ++u) w[u] = __ldg(t + u * S);
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) {
      if (k & half) continue;
      ct(x[k], x[k + half], w[k & (half - 1)], q);
    }
  }
}

// A radix-3 DIF butterfly with its two twiddles t[0], t[1]: 3 products,
// y0 = a + b + c, y1 = w1 (a - c + w3 (b - c)), y2 = w2 (a - b - w3 (b - c)).
// In and out: [0, 2q).
__device__ __forceinline__ void dif3(u64& a, u64& b, u64& c, Pair w3, const Pair* t, u64 q) {
  const Pair w1 = __ldg(t), w2 = __ldg(t + 1);
  const u64 y0 = csub(csub(a + b + c, 4 * q), 2 * q);
  const u64 s = shoup_mul(b + 2 * q - c, w3, q);
  const u64 y1 = shoup_mul(a + 2 * q - c + s, w1, q);
  const u64 y2 = shoup_mul(a + 4 * q - b - s, w2, q);
  a = y0;
  b = y1;
  c = y2;
}

// Its inverse times 3 (inverse twiddles, w3 the inverse cube root).  In
// and out: [0, 4q).
__device__ __forceinline__ void dit3(u64& a, u64& b, u64& c, Pair w3, const Pair* t, u64 q) {
  const Pair w1 = __ldg(t), w2 = __ldg(t + 1);
  const u64 y1 = shoup_mul(b, w1, q), y2 = shoup_mul(c, w2, q);
  const u64 y0 = csub(a, 2 * q);
  const u64 s = shoup_mul(y1 + 2 * q - y2, w3, q);
  a = csub(y0 + y1 + y2, 4 * q);
  b = csub(y0 + 2 * q - y2 + s, 4 * q);
  c = csub(y0 + 4 * q - y1 - s, 4 * q);
}

// ----------------------------------------------------------------------------
// The run-time geometry of a launch (set on the host by `launch`).
// ----------------------------------------------------------------------------

struct Geo {
  int n;          // N
  u32 m;          // M = N / 2 = 2^p 3^b
  int p, b;       // radix-2 and radix-3 stages
  u32 q_local;    // Q = M / C, the words a CTA holds of each branch
  u32 bstride;    // words between its two branch buffers
  int limbs;      // L: row r uses limb r mod L
  int width;      // pairs of a limb's row
};

struct Row {
  const Pair* tab;  // the limb's row
  u64 q;
  u32 rank;         // CTA rank in the cluster
};

template <int C>
__device__ __forceinline__ Row row_state(const u64* tabs, const Geo& g, size_t row) {
  Row r;
  const int limb = static_cast<int>(row % g.limbs);
  r.tab = reinterpret_cast<const Pair*>(tabs) + static_cast<size_t>(limb) * g.width;
  r.q = __ldg(r.tab).x;
  r.rank = 0;
  if constexpr (C > 1) r.rank = cg::this_cluster().block_rank();
  return r;
}

// ----------------------------------------------------------------------------
// Local passes over a CTA's 2 Q words (both branches), forward order: the
// radix-2 stages c .. p-1 in passes of R <= 3, then one radix-3 stage a
// pass.  Each pass is closed by a barrier.
// ----------------------------------------------------------------------------

template <int R, bool FWD>
__device__ __forceinline__ void pass2(u64* a, const Geo& g, const Row& r, int s) {
  const u32 ms = g.m >> s;            // block size of the pass's first stage
  const u32 S = ms >> R;
  const u32 G = g.q_local >> R;       // groups a branch
  const u32 rs = recip(S);
#pragma unroll 1
  for (u32 gid = threadIdx.x; gid < 2 * G; gid += blockDim.x) {
    const u32 br = gid >= G;
    const u32 gg = gid - (br ? G : 0u);
    const u32 blk = udiv(gg, rs);
    const u32 jj = gg - blk * S;
    u64* p = a + (br ? g.bstride : 0u);
    const u32 base = blk * (S << R) + jj;
    u64 x[1 << R];
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) x[k] = p[phys(base + k * S)];
    if constexpr (FWD) {
      dif2<R>(x, r.tab, g.m, ms, jj, S, r.q);
    } else {
      dit2<R>(x, r.tab, g.m, ms, jj, S, r.q);
    }
#pragma unroll
    for (int k = 0; k < (1 << R); ++k) p[phys(base + k * S)] = x[k];
  }
}

template <bool FWD>
__device__ __forceinline__ void pass3(u64* a, const Geo& g, const Row& r, u32 ms) {
  const u32 S = ms / 3;
  const u32 G = g.q_local / 3;
  const u32 rs = recip(S);
  const Pair w3 = __ldg(r.tab + 2);
  const Pair* t = stage_tab(r.tab, g.m, ms);
#pragma unroll 1
  for (u32 gid = threadIdx.x; gid < 2 * G; gid += blockDim.x) {
    const u32 br = gid >= G;
    const u32 gg = gid - (br ? G : 0u);
    const u32 blk = udiv(gg, rs);
    const u32 jj = gg - blk * S;
    u64* p = a + (br ? g.bstride : 0u);
    const u32 base = blk * ms + jj;
    u64 x0 = p[phys(base)], x1 = p[phys(base + S)], x2 = p[phys(base + 2 * S)];
    if constexpr (FWD) {
      dif3(x0, x1, x2, w3, t + 2 * jj, r.q);
    } else {
      dit3(x0, x1, x2, w3, t + 2 * jj, r.q);
    }
    p[phys(base)] = x0;
    p[phys(base + S)] = x1;
    p[phys(base + 2 * S)] = x2;
  }
}

template <bool FWD>
__device__ __forceinline__ void pass2_any(int R, u64* a, const Geo& g, const Row& r, int s) {
  if (R == 3) {
    pass2<3, FWD>(a, g, r, s);
  } else if (R == 2) {
    pass2<2, FWD>(a, g, r, s);
  } else {
    pass2<1, FWD>(a, g, r, s);
  }
}

// The forward local passes from radix-2 stage c on.
__device__ __forceinline__ void fwd_local(u64* a, const Geo& g, const Row& r, int c) {
  const int n2 = g.p - c;
#pragma unroll 1
  for (int s0 = 0; s0 < n2;) {
    const int R = pass_from(n2, s0);
    pass2_any<true>(R, a, g, r, c + s0);
    __syncthreads();
    s0 += R;
  }
  u32 ms = g.m >> g.p;  // 3^b
#pragma unroll 1
  for (int k = 0; k < g.b; ++k, ms /= 3) {
    pass3<true>(a, g, r, ms);
    __syncthreads();
  }
}

// The inverse local passes: the radix-3 stages last first, then the radix-2
// passes last first, down to stage c.
__device__ __forceinline__ void bwd_local(u64* a, const Geo& g, const Row& r, int c) {
  u32 ms = 3;
#pragma unroll 1
  for (int k = 0; k < g.b; ++k, ms *= 3) {
    pass3<false>(a, g, r, ms);
    __syncthreads();
  }
  const int n2 = g.p - c;
#pragma unroll 1
  for (int end = n2; end > 0;) {
    const int R = pass_to(n2, end);
    end -= R;
    pass2_any<false>(R, a, g, r, c + end);
    __syncthreads();
  }
}

// ----------------------------------------------------------------------------
// The fold and twist (forward load) and the untwist and CRT (inverse store)
// of word j of both branches.
// ----------------------------------------------------------------------------

struct Fold {
  Pair z;     // z = omega^M (the header's pair 1)
  Pair d;     // (z - z^5)^-1, inverse only (pair 3)
};

__device__ __forceinline__ void fold_twist(const u64* __restrict__ src, u32 j, const Geo& g,
                                           const Row& r, Pair z, u64& a0, u64& a1) {
  const u64 lo = __ldg(src + j), hi = __ldg(src + g.m + j);
  const u64 q = r.q;
  const u64 t = shoup_mul(hi, z, q);
  a0 = shoup_mul(lo + t, __ldg(r.tab + kHeader + j), q);
  a1 = shoup_mul(lo + hi + 2 * q - t, __ldg(r.tab + kHeader + g.m + j), q);
}

__device__ __forceinline__ void untwist_crt(u64 a0, u64 a1, u32 j, const Geo& g, const Row& r,
                                            const Fold& f, u64* __restrict__ dst) {
  const u64 q = r.q;
  const u64 u = shoup_mul(a0, __ldg(r.tab + kHeader + j), q);
  const u64 w = shoup_mul(a1, __ldg(r.tab + kHeader + g.m + j), q);
  const u64 hi = csub(shoup_mul(u + 2 * q - w, f.d, q), q);
  dst[j] = csub(csub(u + 2 * q - shoup_mul(hi, f.z, q), 2 * q), q);
  dst[g.m + j] = hi;
}

// ----------------------------------------------------------------------------
// The radix-C pass across the cluster: stages 0 .. log2(C)-1 on the words
// jj + t Q (t < C) of each branch, for this CTA's share of the offsets
// jj < Q; word t lies at jj in CTA t's buffer (part[t]).
// ----------------------------------------------------------------------------

template <int C>
__device__ __forceinline__ void fwd_cross(u64* const (&part)[C], const u64* __restrict__ src,
                                          const Geo& g, const Row& r, Pair z) {
  constexpr int LC = log2i(C);
  const u32 Q = g.q_local;
  const u32 first = r.rank * Q / C, last = (r.rank + 1) * Q / C;
#pragma unroll 1
  for (u32 jj = first + threadIdx.x; jj < last; jj += blockDim.x) {
    u64 x0[C], x1[C];
#pragma unroll
    for (int t = 0; t < C; ++t) fold_twist(src, jj + t * Q, g, r, z, x0[t], x1[t]);
    dif2<LC>(x0, r.tab, g.m, g.m, jj, Q, r.q);
    dif2<LC>(x1, r.tab, g.m, g.m, jj, Q, r.q);
    const u32 pj = phys(jj);
#pragma unroll
    for (int t = 0; t < C; ++t) {
      part[t][pj] = x0[t];
      part[t][g.bstride + pj] = x1[t];
    }
  }
}

template <int C>
__device__ __forceinline__ void bwd_cross(u64* const (&part)[C], u64* __restrict__ dst,
                                          const Geo& g, const Row& r, const Fold& f) {
  constexpr int LC = log2i(C);
  const u32 Q = g.q_local;
  const u32 first = r.rank * Q / C, last = (r.rank + 1) * Q / C;
#pragma unroll 1
  for (u32 jj = first + threadIdx.x; jj < last; jj += blockDim.x) {
    u64 x0[C], x1[C];
    const u32 pj = phys(jj);
#pragma unroll
    for (int t = 0; t < C; ++t) {
      x0[t] = part[t][pj];
      x1[t] = part[t][g.bstride + pj];
    }
    dit2<LC>(x0, r.tab, g.m, g.m, jj, Q, r.q);
    dit2<LC>(x1, r.tab, g.m, g.m, jj, Q, r.q);
#pragma unroll
    for (int t = 0; t < C; ++t) untwist_crt(x0[t], x1[t], jj + t * Q, g, r, f, dst);
  }
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

// ----------------------------------------------------------------------------
// Kernels: one row over a cluster of C CTAs (C = 1: one CTA).
// ----------------------------------------------------------------------------

template <int C>
__global__ void __launch_bounds__(kMaxThreads, 1)
ntt3n_fwd_kernel(const u64* __restrict__ in, u64* __restrict__ out, const u64* __restrict__ tabs,
                 const int* __restrict__ kidx, Geo g) {
  extern __shared__ u64 a[];
  const size_t row = blockIdx.x / C;
  const Row r = row_state<C>(tabs, g, row);
  const Pair z = __ldg(r.tab + 1);
  const u64* src = in + row * g.n;
  const u32 Q = g.q_local;
  if constexpr (C > 1) {
    u64* part[C];
    map_parts<C>(part, a);
    cg::this_cluster().sync();  // every CTA has started
    fwd_cross<C>(part, src, g, r, z);
    cg::this_cluster().sync();
  } else {
#pragma unroll 1
    for (u32 j = threadIdx.x; j < g.m; j += blockDim.x) {
      fold_twist(src, j, g, r, z, a[phys(j)], a[g.bstride + phys(j)]);
    }
    __syncthreads();
  }
  fwd_local(a, g, r, log2i(C));
  u64* dst = out + row * g.n;
  const int* idx = kidx + r.rank * Q;
#pragma unroll 1
  for (u32 i = threadIdx.x; i < 2 * Q; i += blockDim.x) {
    const u32 br = i >= Q;
    const u32 pos = i - (br ? Q : 0u);
    dst[__ldg(idx + (br ? g.m : 0u) + pos)] = csub(a[(br ? g.bstride : 0u) + phys(pos)], r.q);
  }
}

template <int C>
__global__ void __launch_bounds__(kMaxThreads, 1)
ntt3n_bwd_kernel(const u64* __restrict__ in, u64* __restrict__ out, const u64* __restrict__ tabs,
                 const int* __restrict__ kidx, Geo g) {
  extern __shared__ u64 a[];
  const size_t row = blockIdx.x / C;
  const Row r = row_state<C>(tabs, g, row);
  const Fold f = {__ldg(r.tab + 1), __ldg(r.tab + 3)};
  const u64* src = in + row * g.n;
  const u32 Q = g.q_local;
  const int* idx = kidx + r.rank * Q;
#pragma unroll 1
  for (u32 i = threadIdx.x; i < 2 * Q; i += blockDim.x) {
    const u32 br = i >= Q;
    const u32 pos = i - (br ? Q : 0u);
    a[(br ? g.bstride : 0u) + phys(pos)] = __ldg(src + __ldg(idx + (br ? g.m : 0u) + pos));
  }
  __syncthreads();
  bwd_local(a, g, r, log2i(C));
  u64* dst = out + row * g.n;
  if constexpr (C > 1) {
    u64* part[C];
    map_parts<C>(part, a);
    cg::this_cluster().sync();  // every CTA's local passes are done
    bwd_cross<C>(part, dst, g, r, f);
    cg::this_cluster().sync();  // the other CTAs read this one's buffers until here
  } else {
#pragma unroll 1
    for (u32 j = threadIdx.x; j < g.m; j += blockDim.x) {
      untwist_crt(a[phys(j)], a[g.bstride + phys(j)], j, g, r, f, dst);
    }
  }
}

// ----------------------------------------------------------------------------
// Launch.
// ----------------------------------------------------------------------------

using Kernel = void (*)(const u64*, u64*, const u64*, const int*, Geo);

template <int C>
Kernel kernel_for(bool fwd) {
  return fwd ? ntt3n_fwd_kernel<C> : ntt3n_bwd_kernel<C>;
}

// Shared memory a kernel may use is raised above 48 KB once per kernel and
// device, here to the largest size launched so far.
std::atomic<size_t> configured[2][4][64];

cudaError_t configure(Kernel kernel, bool fwd, int lc, size_t smem, int dev) {
  std::atomic<size_t>& done = configured[fwd][lc][dev & 63];
  if (done.load(std::memory_order_acquire) >= smem) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  size_t cur = done.load(std::memory_order_relaxed);
  while (cur < smem && !done.compare_exchange_weak(cur, smem)) {
  }
  return cudaSuccess;
}

// The geometry of degree n = 2^(p+1) 3^b split over `cluster` CTAs, or
// false if the kernel does not take it.
bool geometry(int n, int p, int b, int cluster, int limbs, Geo& g, size_t& smem, int& threads) {
  if (n < 8 || n % 2 || p < 0 || b < 0 || limbs < 1 || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) || (1 << p) % cluster) {
    return false;
  }
  u64 m = 1;
  for (int i = 0; i < p; ++i) m *= 2;
  for (int i = 0; i < b; ++i) m *= 3;
  if (2 * m != static_cast<u64>(n) || m < 4 || m > (1u << 20)) return false;
  g.n = n;
  g.m = static_cast<u32>(m);
  g.p = p;
  g.b = b;
  g.q_local = g.m / cluster;
  g.bstride = branch_stride(g.q_local);
  g.limbs = limbs;
  g.width = static_cast<int>(3 * m + kHeader - 1);
  smem = sizeof(u64) * 2 * g.bstride;
  if (smem > kMaxSmem || 2ull * g.q_local * 2 >= (1ull << 31)) return false;
  // one thread a radix-8 group of the CTA's 2 Q words, 32 to 256
  const u32 want = (2 * g.q_local / 8 + 31) / 32 * 32;
  threads = static_cast<int>(want < 32 ? 32 : (want > kMaxThreads ? kMaxThreads : want));
  return true;
}

int launch(bool fwd, const void* in, void* out, const void* tabs, const void* kidx, int rows,
           int limbs, int n, int p, int b, int cluster, int dev, void* stream) {
  Geo g;
  size_t smem = 0;
  int threads = 0;
  if (rows < 0 || !geometry(n, p, b, cluster, limbs, g, smem, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int lc = log2i(cluster);
  Kernel (*const by_c[4])(bool) = {kernel_for<1>, kernel_for<2>, kernel_for<4>, kernel_for<8>};
  const Kernel kernel = by_c[lc](fwd);
  err = configure(kernel, fwd, lc, smem, dev);
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(rows) * cluster, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cluster > 1 ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const u64*>(in), static_cast<u64*>(out),
                             static_cast<const u64*>(tabs), static_cast<const int*>(kidx), g);
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  if (prev != dev) cudaSetDevice(prev);
  return static_cast<int>(err);
}

}  // namespace

// C entry points, bound with ctypes (matrix_fhe_tpu_torch/ops/ntt3n_cuda.py).
// `in` and `out` are device pointers of int64 [rows, N] words read as
// uint64; `tabs` the [L, 2 W] words of the direction's rows (kfwd or kbwd,
// row r uses limb r mod `limbs`), 16-byte aligned; `kidx` the int32 [N]
// composed index; N = 2^(p+1) 3^b; `cluster` (1, 2, 4 or 8, dividing 2^p)
// the CTAs a row is split over; `device` the CUDA device of the pointers
// and `stream` a stream of it.  The return value is the CUDA error of the
// launch (0 on success; cudaErrorInvalidValue for a size, split or cluster
// the kernel does not take).

extern "C" int mfhe_ntt3n_fwd(const void* in, void* out, const void* tabs, const void* kidx,
                              int rows, int limbs, int n, int p, int b, int cluster, int device,
                              void* stream) {
  return launch(true, in, out, tabs, kidx, rows, limbs, n, p, b, cluster, device, stream);
}

extern "C" int mfhe_ntt3n_bwd(const void* in, void* out, const void* tabs, const void* kidx,
                              int rows, int limbs, int n, int p, int b, int cluster, int device,
                              void* stream) {
  return launch(false, in, out, tabs, kidx, rows, limbs, n, p, b, cluster, device, stream);
}
