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
// products) and ~4.6 MB of words: the 32-bit multiply-adds of the FMA pipe
// bound it (chip_smoke.py's _b6_bound counts 8 a multiply-accumulate).  A
// MAC here is four IMAD.WIDE.U32, which the H100 issues at ~24 a clock a SM
// (tools/int_mul_rate.cu), not the 32 the bound's 64 multiply-adds imply.
//
// What the design does about it (`tiled_kernel`):
//   * A CTA takes one (lead, limb) and a tile of `ti` output rows; each
//     thread owns one tile of 2 x cn outputs (cn = 2 or 4) of each product.
//     The host's rule (ops/ntt_sharded_cuda.py:geometry, from
//     tools/ntt_sharded_ab.py --sweep) gives N <= 2^14 CTAs of 128 threads
//     and 4 rows, 2 x 2 tiles (640 CTAs at phase 26's blocks, ~5 a SM),
//     and larger N CTAs of 256 threads with 2 x 4 tiles.  Launch bounds of
//     768 (2 x 2) or 512 (2 x 4) threads a SM cap the registers at 80 / 128.
//   * A thread's outputs are independent sums: every term a 2 x cn outer
//     product of two left and cn right words, so a shared load feeds cn or
//     two multiply-accumulates (the right operand's words come as 16-byte
//     pairs, a warp's loads of a pair one contiguous 512 B).
//   * A MAC is a 64 x 64 -> 128-bit product of four IMAD.WIDE.U32 (the two
//     middle ones adding into one word: the words are below 2^61) and one
//     32-bit carry chain into the 128-bit sum, written in PTX so that ptxas
//     adds nothing around it (`mac`: ~11 SASS instructions a MAC in the hot
//     loops, tools/ntt_sass.py --b6).  At most 64 terms (each < q^2 <
//     2^122, so the sum stays below 2^128) are reduced once: hi 2^64 + lo
//     -> (hi mod q by Barrett on the high word, + lo 2^-64 mod q by a
//     Montgomery step) mod q, which is the sum of the terms' Montgomery
//     products mod q.  Any exact order of summation gives the same
//     canonical word.
//   * Step 1 (A @ x) has few outputs and a long sum (R terms): where its
//     tiles are fewer than the threads, `s1` threads share a tile, each
//     summing a slice of every stage, and their partials meet in the
//     stage just consumed; W = (A @ x) .* T is kept in shared memory,
//     transposed, between the two products.
//   * The operands come through a ring of two shared-memory stages filled
//     by cp.async: the block's rows in step 1, B^T's rows in step 2; the
//     CTA's rows of A and T's tile come at the start and stay.  The next
//     stage is in flight while the threads work on the current one.  A
//     third stage, measured, cost more in CTAs a SM than it gained.
// `simple_kernel` takes the blocks of one column (c = 1): one output row a
// CTA, its sums in chunks of 64 terms, as the tiled kernel's.
// Tensor cores are not used: they have no 64-bit integer product.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
typedef unsigned int u32;

constexpr int kChunk = 64;         // terms summed in 128 bits between reductions
constexpr int kMaxCols = 512;      // C (N <= 2^18)
constexpr int kStageWords = 2048;  // one stage of the copy ring (16 KB)
constexpr int kSimpleThreads = 256;

struct Modulus {
  u64 q, qinv, bhi;
};

// lo/hi += a * b for words a, b < 2^61 (a 128-bit accumulator; the caller
// keeps it below 2^128).  With a = a1 2^32 + a0 (a1 < 2^29) and b alike, the
// product is p + m 2^32 + h 2^64: p = a0 b0, m = a0 b1 + a1 b0 < 2^62 (the
// second product adds the first: no carry) and h = a1 b1, three 64-bit
// words of four IMAD.WIDE.U32; m 2^32 only shifts m's halves, so the add is
// one 32-bit carry chain through the accumulator's four words.
__device__ __forceinline__ void mac(u64& lo, u64& hi, u64 a, u64 b) {
  u32 l0 = static_cast<u32>(lo), l1 = static_cast<u32>(lo >> 32);
  u32 h0 = static_cast<u32>(hi), h1 = static_cast<u32>(hi >> 32);
  asm("{\n\t.reg .u64 p, m, h;\n\t.reg .u32 p0, p1, m0, m1, h0, h1;\n\t"
      "mul.wide.u32 p, %4, %6;\n\t"
      "mul.wide.u32 m, %4, %7;\n\t"
      "mad.wide.u32 m, %5, %6, m;\n\t"
      "mul.wide.u32 h, %5, %7;\n\t"
      "mov.b64 {p0, p1}, p;\n\t"
      "mov.b64 {m0, m1}, m;\n\t"
      "mov.b64 {h0, h1}, h;\n\t"
      "add.cc.u32 %0, %0, p0;\n\t"
      "addc.cc.u32 %1, %1, p1;\n\t"
      "addc.cc.u32 %2, %2, h0;\n\t"
      "addc.u32 %3, %3, h1;\n\t"
      "add.cc.u32 %1, %1, m0;\n\t"
      "addc.cc.u32 %2, %2, m1;\n\t"
      "addc.u32 %3, %3, 0;\n\t}"
      : "+r"(l0), "+r"(l1), "+r"(h0), "+r"(h1)
      : "r"(static_cast<u32>(a)), "r"(static_cast<u32>(a >> 32)), "r"(static_cast<u32>(b)),
        "r"(static_cast<u32>(b >> 32)));
  lo = (static_cast<u64>(l1) << 32) | l0;
  hi = (static_cast<u64>(h1) << 32) | h0;
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

// s[k] += the reduced sums of the accumulators (lo[k], hi[k]), then cleared
template <int kN>
__device__ __forceinline__ void drain(u64 (&lo)[kN], u64 (&hi)[kN], u64 (&s)[kN],
                                      const Modulus& m) {
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    s[k] = add_mod(s[k], reduce(lo[k], hi[k], m), m.q);
    lo[k] = hi[k] = 0;
  }
}

// The sums of a thread's 2 x kCn tile over `len` terms t: acc[r kCn + 2 p + e] +=
// left[r][t] * right[t][p seg + e] (r, e < 2, p < kCn / 2).  The left words
// of rows 0 and 1 are at left[t * ls] and left[t * ls + lrow] (with kPair
// adjacent, lrow = 1, one 16-byte load), the right pairs at
// right[t * rs + p * seg], 16-byte aligned.
template <int kCn, bool kPair>
__device__ __forceinline__ void tile_sum(u64 (&lo)[2 * kCn], u64 (&hi)[2 * kCn],
                                         const u64* left, int lrow, int ls, const u64* right,
                                         int rs, int seg, int len) {
#pragma unroll 4
  for (int t = 0; t < len; ++t) {
    u64 a[2];
    if (kPair) {
      const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(left + t * ls);
      a[0] = v.x;
      a[1] = v.y;
    } else {
      a[0] = left[t * ls];
      a[1] = left[t * ls + lrow];
    }
#pragma unroll
    for (int p = 0; p < kCn / 2; ++p) {
      const ulonglong2 r = *reinterpret_cast<const ulonglong2*>(right + t * rs + p * seg);
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        mac(lo[row * kCn + 2 * p], hi[row * kCn + 2 * p], a[row], r.x);
        mac(lo[row * kCn + 2 * p + 1], hi[row * kCn + 2 * p + 1], a[row], r.y);
      }
    }
  }
}

__device__ __forceinline__ u32 smem_addr(const void* p) {
  return static_cast<u32>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows x cols words (cols even) from src (row stride sstride) to dst (row
// stride dstride), 16 bytes a copy, by `threads` threads
__device__ __forceinline__ void copy_rows(u64* dst, int dstride, const u64* src, size_t sstride,
                                          int rows, int cols, int t, int threads) {
  const int pairs = cols >> 1;
  for (int e = t; e < rows * pairs; e += threads) {
    const int r = e / pairs, p = e - r * pairs;
    cp_async16(dst + r * dstride + 2 * p, src + r * sstride + 2 * p);
  }
}

// Geometry, from the host: ti output rows a CTA; step 1 in stages of kc1
// rows of x, its 2 x kCn tiles shared by s1 threads (each summing
// kc1 / s1 <= kChunk terms of a stage); step 2 in stages of kc2 <= kChunk
// rows of B^T.
struct Geometry {
  int ti, kc1, s1, kc2;
};

// A thread's 2 x kCn tile of a [ti, width] product: rows r, r + 1, columns
// j + p seg + e (seg = width / (kCn / 2)), so that a warp's right loads of
// each p are one contiguous run.
struct Tile {
  int r, j, seg;
};

template <int kCn>
__device__ __forceinline__ Tile tile_of(int index, int width) {
  const int seg = width / (kCn / 2), across = seg / 2;
  return {2 * (index / across), 2 * (index % across), seg};
}

template <int kThreads, int kCn>
__global__ void __launch_bounds__(kThreads, (kCn == 2 ? 768 : 512) / kThreads)
    tiled_kernel(const u64* __restrict__ x, u64* __restrict__ out, const u64* __restrict__ a_mat,
                 const u64* __restrict__ tw, const u64* __restrict__ bt,
                 const u64* __restrict__ moduli, const u64* __restrict__ qinv,
                 const u64* __restrict__ bhi, int limbs, int R, int C, int c, int col0,
                 Geometry g) {
  constexpr int kOut = 2 * kCn;  // outputs a thread holds in either product
  extern __shared__ __align__(16) u64 smem[];
  const int ti = g.ti, kc1 = g.kc1, kc2 = g.kc2, s1 = g.s1;
  const int as = R + 2;                      // A's row stride: rows land on other banks
  u64* const a_s = smem + 2 * kStageWords;  // [ti, R]: A's rows (the ring: 2 stages before)
  u64* const w_t = a_s + ti * as;           // [c, ti]: W^T
  u64* const tws = w_t + c * ti;            // [ti, c]: T's tile

  const int tiles = R / ti;
  const int bl = blockIdx.x / tiles;  // (lead, limb) row of the block
  const int i0 = (blockIdx.x % tiles) * ti;
  const int l = bl % limbs;
  const Modulus m{moduli[l], qinv[l], bhi[l]};
  const u64* const xb = x + static_cast<size_t>(bl) * R * c;
  const u64* const al = a_mat + (static_cast<size_t>(l) * R + i0) * R;
  const u64* const btl = bt + (static_cast<size_t>(l) * C + col0) * C;
  u64* const ob = out + (static_cast<size_t>(bl) * R + i0) * C;
  const int t = threadIdx.x;
  const int n1 = R / kc1, n2 = c / kc2;

  auto issue = [&](int s) {
    u64* const dst = smem + (s & 1) * kStageWords;
    if (s < n1)
      copy_rows(dst, c, xb + static_cast<size_t>(s) * kc1 * c, c, kc1, c, t, kThreads);
    else
      copy_rows(dst, C, btl + static_cast<size_t>(s - n1) * kc2 * C, C, kc2, C, t, kThreads);
  };

  copy_rows(a_s, as, al, R, ti, R, t, kThreads);
  copy_rows(tws, c, tw + (static_cast<size_t>(l) * R + i0) * C + col0, C, ti, c, t, kThreads);
  issue(0);
  cp_async_commit();

  // step 1's task: a tile of W's [ti, c], slice p1 of each stage's rows
  const int tiles1 = (ti / 2) * (c / kCn);
  const bool on1 = t < tiles1 * s1;
  const int p1 = t / tiles1, len1 = kc1 / s1;
  const Tile w1 = tile_of<kCn>(t % tiles1, c);
  // step 2's tile of the output's [ti, C]
  const bool on2 = t < (ti / 2) * (C / kCn);
  const Tile w2 = tile_of<kCn>(t, C);

  u64 lo[kOut], hi[kOut], s[kOut];
  int terms = 0;
#pragma unroll
  for (int k = 0; k < kOut; ++k) lo[k] = hi[k] = s[k] = 0;

  for (int st = 0; st < n1 + n2; ++st) {
    if (st + 1 < n1 + n2) {
      issue(st + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const u64* const cur = smem + (st & 1) * kStageWords;
    if (st < n1) {
      if (on1) {
        const int k0 = p1 * len1;
        if (terms + len1 > kChunk) {
          drain(lo, hi, s, m);
          terms = 0;
        }
        tile_sum<kCn, false>(lo, hi, a_s + w1.r * as + st * kc1 + k0, as, 1,
                             cur + k0 * c + w1.j, c, w1.seg, len1);
        terms += len1;
      }
      if (st == n1 - 1) {  // step 1's end: W = (sum of the slices) .* T, transposed
        // the partials [s1, ti, c] take the stage just consumed
        u64* const part = smem + (st & 1) * kStageWords;
        if (on1) drain(lo, hi, s, m);
        __syncthreads();
        if (on1) {
#pragma unroll
          for (int k = 0; k < kOut; ++k)
            part[(p1 * ti + w1.r + k / kCn) * c + w1.j + (k % kCn / 2) * w1.seg + k % 2] = s[k];
        }
        terms = 0;
#pragma unroll
        for (int k = 0; k < kOut; ++k) s[k] = 0;
        __syncthreads();
        for (int o = t; o < ti * c; o += kThreads) {
          u64 y = part[o];
          for (int p = 1; p < s1; ++p) y = add_mod(y, part[p * ti * c + o], m.q);
          const u64 tv = tws[o];
          const int i = o / c, j = o - i * c;
          w_t[j * ti + i] = reduce(y * tv, __umul64hi(y, tv), m);
        }
      }
    } else if (on2) {
      const int m0 = (st - n1) * kc2;
      if (terms + kc2 > kChunk) {
        drain(lo, hi, s, m);
        terms = 0;
      }
      // the left pair (rows r, r + 1) is adjacent in W^T
      tile_sum<kCn, true>(lo, hi, w_t + m0 * ti + w2.r, 1, ti, cur + w2.j, C, w2.seg, kc2);
      terms += kc2;
    }
    __syncthreads();  // the stage is consumed before it is filled again
  }
  if (on2) {
    drain(lo, hi, s, m);
#pragma unroll
    for (int k = 0; k < kOut; k += 2)
      *reinterpret_cast<ulonglong2*>(ob + static_cast<size_t>(w2.r + k / kCn) * C + w2.j +
                                     (k % kCn / 2) * w2.seg) = make_ulonglong2(s[k], s[k + 1]);
  }
}

// One output a thread, one row of the output a CTA: the blocks of c = 1.
__global__ void __launch_bounds__(kSimpleThreads)
    simple_kernel(const u64* __restrict__ x, u64* __restrict__ out, const u64* __restrict__ a_mat,
                  const u64* __restrict__ tw, const u64* __restrict__ bt,
                  const u64* __restrict__ moduli, const u64* __restrict__ qinv,
                  const u64* __restrict__ bhi, int limbs, int R, int C, int col0) {
  const int bl = blockIdx.x / R, i = blockIdx.x % R;
  const int l = bl % limbs;
  const Modulus m{moduli[l], qinv[l], bhi[l]};
  const u64* const xb = x + static_cast<size_t>(bl) * R;
  const u64* const ar = a_mat + (static_cast<size_t>(l) * R + i) * R;
  // W[i] = (sum_r A[i, r] x[r]) T[i, col0], every thread computing it
  u64 y = 0;
  for (int r0 = 0; r0 < R; r0 += kChunk) {
    u64 lo = 0, hi = 0;
    for (int r = r0; r < r0 + kChunk && r < R; ++r) mac(lo, hi, ar[r], xb[r]);
    y = add_mod(y, reduce(lo, hi, m), m.q);
  }
  const u64 tv = tw[(static_cast<size_t>(l) * R + i) * C + col0];
  const u64 w = reduce(y * tv, __umul64hi(y, tv), m);
  const u64* const btr = bt + (static_cast<size_t>(l) * C + col0) * C;
  for (int j = threadIdx.x; j < C; j += kSimpleThreads)
    out[(static_cast<size_t>(bl) * R + i) * C + j] = reduce(w * btr[j], __umul64hi(w, btr[j]), m);
}

}  // namespace

// C entry point, bound with ctypes (matrix_fhe_tpu_torch/ops/ntt_sharded_cuda.py).
// Pointers are device pointers of contiguous int64 tensors read as uint64:
// x [lead, limbs, R, c], out [lead, limbs, R, C], a_mat [limbs, R, R],
// tw [limbs, R, C], bt [limbs, C, C], moduli / qinv / bhi [limbs];
// col0 the block's first column.  R <= C powers of two, C <= 512 (N <= 2^18),
// c dividing C.  c = 1 takes the simple kernel; for c >= 2 the tiled kernel
// runs with `threads` threads (128 or 256), tiles of 2 x cn outputs a
// thread (cn = 2 or 4, dividing c) and the geometry g (all powers of two;
// ops/ntt_sharded_cuda.py:geometry picks it): ti | R rows a CTA,
// ti * C <= 2 * cn * threads; kc1 | R rows of x a stage, in kStageWords;
// s1 threads a step-1 tile, at most the threads and kc1, kc1 <= kChunk * s1,
// their partials in a stage (s1 * ti * c <= kStageWords); kc2 | c rows of B^T a stage,
// kc2 <= kChunk, kc2 * C <= kStageWords.  Launches on `stream` of `device`
// (the calling thread's device is switched to it for the launch and back)
// and returns the CUDA error of the launch (0 on success).
extern "C" int mfhe_ntt_sharded_local(const void* x, void* out, const void* a_mat,
                                      const void* tw, const void* bt, const void* moduli,
                                      const void* qinv, const void* bhi, int lead, int limbs,
                                      int R, int C, int c, int col0, int threads, int ti,
                                      int cn, int kc1, int s1, int kc2, int device,
                                      void* stream) {
  auto pow2 = [](int v) { return v > 0 && !(v & (v - 1)); };
  if (lead < 0 || limbs <= 0 || R < 2 || C < 2 || c <= 0 || C > kMaxCols || R > C || C % c ||
      col0 < 0 || col0 + c > C || !pow2(R) || !pow2(C))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{ti, kc1, s1, kc2};
  if (c > 1 && ((threads != 128 && threads != 256) || (cn != 2 && cn != 4) || c % cn ||
                !pow2(ti) || ti < 2 || ti > R || ti * C > 2 * cn * threads || !pow2(kc1) ||
                kc1 > R || !pow2(s1) || s1 > kc1 || kc1 > kChunk * s1 ||
                (ti / 2) * (c / cn) * s1 > threads ||
                kc1 * c > kStageWords || s1 * ti * c > kStageWords || !pow2(kc2) || kc2 > c ||
                kc2 > kChunk || kc2 * C > kStageWords))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lead == 0) return 0;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto px = static_cast<const u64*>(x);
  const auto pa = static_cast<const u64*>(a_mat);
  const auto pt = static_cast<const u64*>(tw);
  const auto pb = static_cast<const u64*>(bt);
  const auto pq = static_cast<const u64*>(moduli);
  const auto pqi = static_cast<const u64*>(qinv);
  const auto pbh = static_cast<const u64*>(bhi);
  if (c == 1) {
    simple_kernel<<<static_cast<unsigned>(lead) * limbs * R, kSimpleThreads, 0, s>>>(
        px, static_cast<u64*>(out), pa, pt, pb, pq, pqi, pbh, limbs, R, C, col0);
  } else {
    const size_t smem =
        sizeof(u64) * (2 * kStageWords + static_cast<size_t>(ti) * (R + 2) + 2 * ti * c);
    const unsigned blocks = static_cast<unsigned>(lead) * limbs * (R / ti);
    auto launch = [&](auto kernel) {
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
      if (e == cudaSuccess) {
        kernel<<<blocks, threads, smem, s>>>(px, static_cast<u64*>(out), pa, pt, pb, pq, pqi,
                                             pbh, limbs, R, C, c, col0, g);
      }
      return e;
    };
    if (cn == 2)
      err = threads == 128 ? launch(tiled_kernel<128, 2>) : launch(tiled_kernel<256, 2>);
    else
      err = threads == 128 ? launch(tiled_kernel<128, 4>) : launch(tiled_kernel<256, 4>);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
