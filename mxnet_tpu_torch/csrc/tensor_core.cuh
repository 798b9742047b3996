// Tensor-core building blocks for the port's attention kernels on Hopper
// (sm_90a): attention_fwd.cuh (the forward of B1, B5 and B8),
// flash_mha_packed_bwd.cu (B1's backward), flash_mha_bwd.cu (B5's) and
// flash_attention_partial_bwd.cu (B9).
//
// * mma.sync wrappers: m16n8k8 with TF32 operands and m16n8k16 with bf16
//   or fp16 operands (the 16-bit formats: one code path, `mma16<H>`), fp32
//   accumulators.  A warp owns a 16-row tile; the fragment
//   of thread `lane` (g = lane / 4, t = lane % 4) holds, for the
//   accumulator C (16 x 8), c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t],
//   c3 = C[g+8][2t+1].
// * fp32 products as split TF32: x = big + small with big = tf32(x) and
//   small = tf32(x - big), both rounded as cvt.rna.tf32.f32 rounds; a
//   product is big*small + small*big + big*big, accumulated in fp32.  The
//   dropped small*small term and the rounding of small cost about 2^-22
//   relative, so the product keeps fp32's accuracy at three tensor-core
//   products.  An operand that came from bf16 or fp16 is exact in TF32 (8
//   or 11 significant bits in 11, and fp16's exponents, subnormals
//   included, are normal in TF32), so it needs no split and its product
//   two.
// * Fragment loads from padded shared tiles (row stride `stride<T>(DP)`:
//   DP + 4 fp32 or DP + 8 16-bit elements, which makes every access pattern
//   below free of bank conflicts):
//     a: A[m][k] = X[m][k]       (X row-major over [m][k])
//     b: B[k][n] = X[n][k]       (X row-major over [n][k], e.g. K in Q.K^T)
//     c: B[k][n] = X[k][n]       (X row-major over [k][n], e.g. V in P.V)
//   TF32 pattern c uses a permuted k: logical k = t holds row 2t and
//   k = t + 4 row 2t + 1 of the 8-row step, which is the order in which an
//   accumulator fragment holds its columns, so an accumulator (P, dS)
//   becomes the A operand of the next product with no trip through shared
//   memory (`c_to_a_tf32`).  16-bit fragments (bf16, fp16) come through
//   ldmatrix, pattern c with .trans; an accumulator pair packs straight into
//   16-bit A registers.
// * cp.async staging of a strided row tile into shared memory, 16 bytes a
//   thread where every row is 16-byte aligned, else one element a thread
//   (4-byte cp.async for fp32, a plain load for a 16-bit type); lanes past D and
//   rows past the end read as zero.
// * What the attention kernels over strided (batch, head, row) tensors
//   share: the strides (Layout), the 16-byte row test, the rounding of a
//   value to the input dtype, S = X.Y^T in the input dtype's products,
//   and the store of a warp's 16-row accumulator.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace tc {

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;
template <typename T>
constexpr bool kIsF16 = std::is_same<T, __half>::value;

// row stride, in elements, of a shared tile DP lanes wide
template <typename T>
__host__ __device__ constexpr int stride(int dp) {
  return kIsF32<T> ? dp + 4 : dp + 8;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// TF32 split and the products
// ---------------------------------------------------------------------------

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero, the 13 low bits cleared; finite x), in two integer operations:
// with the cvt itself B1's forward and B9 took 20-30% longer on the H100
// (PERF.md)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&big)[N],
                                      uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], big[i], small[i]);
}

// an operand exact in TF32 (it came from bf16 or fp16): its bits as they
// are
template <int N>
__device__ __forceinline__ void exact(const float (&x)[N],
                                      uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = __float_as_uint(x[i]);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the m16n8k16 product of the 16-bit operand type H (bf16 or fp16)
template <typename H>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  if constexpr (kIsF16<H>)
    mma_f16(c, a, b);
  else
    mma_bf16(c, a, b);
}

// c += a.b, both split: the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma_tf32(c, ab, bs);
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bb);
}

// c += a.b, a split, b exact in TF32
__device__ __forceinline__ void mma2a(float (&c)[4], const uint32_t (&ab)[4],
                                      const uint32_t (&as)[4],
                                      const uint32_t (&b)[2]) {
  mma_tf32(c, as, b);
  mma_tf32(c, ab, b);
}

// c += a.b, a exact in TF32, b split
__device__ __forceinline__ void mma2b(float (&c)[4], const uint32_t (&a)[4],
                                      const uint32_t (&bb)[2],
                                      const uint32_t (&bs)[2]) {
  mma_tf32(c, a, bs);
  mma_tf32(c, a, bb);
}

// ---------------------------------------------------------------------------
// fragments
// ---------------------------------------------------------------------------

__device__ __forceinline__ float lds(const float* p) { return *p; }
__device__ __forceinline__ float lds(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float lds(const __half* p) {
  return __half2float(*p);
}

// TF32 A fragment, pattern a, rows m0.., k0..k0+7 of X (stride SW)
template <int SW, typename T>
__device__ __forceinline__ void frag_a(float (&a)[4], const T* X, int m0,
                                       int k0) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  const T* p = X + (m0 + g) * SW + k0 + t;
  a[0] = lds(p);
  a[1] = lds(p + 8 * SW);
  a[2] = lds(p + 4);
  a[3] = lds(p + 8 * SW + 4);
}

// TF32 B fragment, pattern b: B[k][n] = X[n0 + n][k0 + k]
template <int SW, typename T>
__device__ __forceinline__ void frag_b(float (&b)[2], const T* X, int n0,
                                       int k0) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  const T* p = X + (n0 + g) * SW + k0 + t;
  b[0] = lds(p);
  b[1] = lds(p + 4);
}

// TF32 B fragment, pattern c, permuted k: B[k][n] = X[k0 + k][n0 + n]
template <int SW, typename T>
__device__ __forceinline__ void frag_c(float (&b)[2], const T* X, int k0,
                                       int n0) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  const T* p = X + (k0 + 2 * t) * SW + n0 + g;
  b[0] = lds(p);
  b[1] = lds(p + SW);
}

// an accumulator fragment as the TF32 A operand of a product over its
// columns (permuted k, matching frag_c)
__device__ __forceinline__ void c_to_a_tf32(float (&a)[4],
                                            const float (&c)[4]) {
  a[0] = c[0];
  a[1] = c[2];
  a[2] = c[1];
  a[3] = c[3];
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16-bit A fragment (16 x 16), pattern a, rows m0.., k0..k0+15
template <int SW, typename H>
__device__ __forceinline__ void frag_a16(uint32_t (&a)[4], const H* X,
                                         int m0, int k0) {
  const int l = lane_id();
  ldsm_x4(a, X + (m0 + (l & 15)) * SW + k0 + (l >> 4) * 8);
}

// 16-bit B fragments of two n-tiles, pattern b: r[0..1] for n0..n0+7,
// r[2..3] for n0+8..n0+15, k0..k0+15
template <int SW, typename H>
__device__ __forceinline__ void frag_b16(uint32_t (&r)[4], const H* X,
                                         int n0, int k0) {
  const int l = lane_id();
  ldsm_x4(r, X + (n0 + (l & 7) + ((l >> 4) << 3)) * SW + k0 +
                 ((l >> 3) & 1) * 8);
}

// 16-bit B fragments of two n-tiles, pattern c (ldmatrix .trans)
template <int SW, typename H>
__device__ __forceinline__ void frag_c16(uint32_t (&r)[4], const H* X,
                                         int k0, int n0) {
  const int l = lane_id();
  ldsm_x4_trans(r, X + (k0 + (l & 7) + (((l >> 3) & 1) << 3)) * SW + n0 +
                       ((l >> 4) << 3));
}

// an output element in its tensor's dtype
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

// two values rounded to the 16-bit type H, lo in the low half
template <typename H>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  if constexpr (kIsF16<H>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// the accumulators of n-tiles 2s and 2s+1 as the 16-bit A operand (type H)
// of a product over their 16 columns (each value rounded to H)
template <typename H>
__device__ __forceinline__ void c_to_a16(uint32_t (&a)[4],
                                         const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack16<H>(c0[0], c0[1]);
  a[1] = pack16<H>(c0[2], c0[3]);
  a[2] = pack16<H>(c1[0], c1[1]);
  a[3] = pack16<H>(c1[2], c1[3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = 0.f;
}

// ---------------------------------------------------------------------------
// warp products (a warp's 16-row tile)
// ---------------------------------------------------------------------------

// c[16 x 8*NB] += X.Y^T where X's 16 rows start at row m0 (stride SX) and
// Y's 8*NB rows at row 0 (stride SY), both over DP lanes: pattern a times
// pattern b (q.k^T-like).  ExactX / ExactY: that operand is exact in TF32
// (it came from bf16 or fp16) and is not split.
template <int NB, int DP, int SX, int SY, bool ExactX, bool ExactY,
          typename TX, typename TY>
__device__ __forceinline__ void gemm_abT_tf32(float (&c)[NB][4],
                                              const TX* X, int m0,
                                              const TY* Y) {
#pragma unroll
  for (int ks = 0; ks < DP / 8; ++ks) {
    float af[4];
    uint32_t ab[4], as[4];
    frag_a<SX>(af, X, m0, ks * 8);
    if constexpr (ExactX)
      exact(af, ab);
    else
      split(af, ab, as);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float bf[2];
      uint32_t bb[2], bs[2];
      frag_b<SY>(bf, Y, j * 8, ks * 8);
      if constexpr (ExactY) {
        exact(bf, bb);
        mma2a(c[j], ab, as, bb);
      } else {
        split(bf, bb, bs);
        if constexpr (ExactX)
          mma2b(c[j], ab, bb, bs);
        else
          mma3(c[j], ab, as, bb, bs);
      }
    }
  }
}

// the same product with both operands of the 16-bit type H (bf16 or
// fp16), on its tensor cores
template <int NB, int DP, int SW, typename H>
__device__ __forceinline__ void gemm_abT16(float (&c)[NB][4], const H* X,
                                           int m0, const H* Y) {
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    uint32_t a[4];
    frag_a16<SW>(a, X, m0, ks * 16);
#pragma unroll
    for (int jj = 0; jj < NB / 2; ++jj) {
      uint32_t r[4];
      frag_b16<SW>(r, Y, jj * 16, ks * 16);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma16<H>(c[2 * jj], a, b0);
      mma16<H>(c[2 * jj + 1], a, b1);
    }
  }
}

// c[16 x 8*NN] += P.Y[:, 8*n0 .. 8*(n0+NN)) where P[16 x 8*NB] is an
// accumulator (already rounded as its dtype wants) whose columns run over
// Y's rows (stride SY): pattern c (p.v-like).  Half: Y is of a 16-bit type
// (bf16, fp16) and P is rounded to it, on its tensor cores; else split
// TF32, three products.
template <int NB, int NN, int SY, bool Half, typename TY>
__device__ __forceinline__ void gemm_pY(float (&c)[NN][4],
                                        const float (&p)[NB][4],
                                        const TY* Y, int n0) {
  if constexpr (Half) {
    static_assert(NN % 2 == 0, "16-bit B fragments come in n-tile pairs");
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
      uint32_t a[4];
      c_to_a16<TY>(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
      for (int nn = 0; nn < NN / 2; ++nn) {
        uint32_t r[4];
        frag_c16<SY>(r, Y, kk * 16, (n0 + 2 * nn) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma16<TY>(c[2 * nn], a, b0);
        mma16<TY>(c[2 * nn + 1], a, b1);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float af[4];
      uint32_t ab[4], as[4];
      c_to_a_tf32(af, p[j]);
      split(af, ab, as);
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        float bf[2];
        uint32_t bb[2], bs[2];
        frag_c<SY>(bf, Y, j * 8, (n0 + n) * 8);
        split(bf, bb, bs);
        mma3(c[n], ab, as, bb, bs);
      }
    }
  }
}

// acc[16 x 8*N] += P.Y (gemm_pY over all of Y's N n-tiles) for an output
// that sums over many tiles.  The tensor cores' fp32 accumulation does not
// round to nearest, so a chain of thousands of mma into one accumulator
// drifts; each tile's products are summed in a fresh accumulator, NN
// n-tiles at a time (which bounds the registers), and added on the CUDA
// cores.
template <int NB, int N, int SY, bool Half, typename TY>
__device__ __forceinline__ void gemm_pY_acc(float (&acc)[N][4],
                                            const float (&p)[NB][4],
                                            const TY* Y) {
  constexpr int NN = N % 8 == 0 ? 8 : 4;
  static_assert(N % NN == 0, "n-tile chunks tile the output");
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += NN) {
    float c[NN][4];
    zero(c);
    gemm_pY<NB, NN, SY, Half>(c, p, Y, n0);
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n0 + n][i] += c[n][i];
  }
}

// ---------------------------------------------------------------------------
// cp.async staging
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one element: fp32 through a 4-byte cp.async (zero-filled when !ok);
// a 16-bit type has no 2-byte cp.async, so a plain load and store
__device__ __forceinline__ void copy_elem(float* dst, const float* src,
                                          bool ok) {
  cp_async4(dst, src, ok ? 4 : 0);
}
__device__ __forceinline__ void copy_elem(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, bool ok) {
  *dst = ok ? *src : __float2bfloat16(0.f);
}
__device__ __forceinline__ void copy_elem(__half* dst, const __half* src,
                                          bool ok) {
  *dst = ok ? *src : __float2half(0.f);
}

// Stage rows r0..r0+R-1, lanes 0..DP-1 of a tensor whose row r starts at
// src + r * row_stride into dst (row stride SW); rows >= nrows and lanes
// >= D are zero.  vec16: every row of src starts 16-byte aligned.
template <typename T, int R, int DP, int SW, int NT>
__device__ __forceinline__ void stage(T* dst, const T* src,
                                      long long row_stride, int r0,
                                      int nrows, int D, bool vec16) {
  if (vec16) {
    constexpr int E = 16 / sizeof(T);
    constexpr int CPR = DP / E;
    static_assert(DP % E == 0 && (SW * sizeof(T)) % 16 == 0,
                  "16-byte chunks tile a row");
    for (int i = threadIdx.x; i < R * CPR; i += NT) {
      const int r = i / CPR;
      const int c = (i % CPR) * E;
      const int row = r0 + r;
      const int n = row < nrows ? max(0, min(E, D - c)) : 0;
      const T* s = n ? src + row * row_stride + c : src;
      cp_async16(dst + r * SW + c, s, n * (int)sizeof(T));
    }
  } else {
    for (int i = threadIdx.x; i < R * DP; i += NT) {
      const int r = i / DP;
      const int c = i % DP;
      const int row = r0 + r;
      const bool ok = row < nrows && c < D;
      copy_elem(dst + r * SW + c, ok ? src + row * row_stride + c : src, ok);
    }
  }
}

// sum over lanes 0..DP-1 of x[c] * y[c], two staged rows that start
// 16-byte aligned, in fp32 (four partial sums, then added)
template <int DP>
__device__ __forceinline__ float row_dot(const float* x, const float* y) {
  static_assert(DP % 4 == 0, "16-byte loads tile the row");
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < DP; c += 4) {
    const float4 a = *reinterpret_cast<const float4*>(x + c);
    const float4 b = *reinterpret_cast<const float4*>(y + c);
    s[0] = fmaf(a.x, b.x, s[0]);
    s[1] = fmaf(a.y, b.y, s[1]);
    s[2] = fmaf(a.z, b.z, s[2]);
    s[3] = fmaf(a.w, b.w, s[3]);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}
__device__ __forceinline__ float2 to_float2(__half2 v) {
  return __half22float2(v);
}

// the same over two rows of a 16-bit type H (bf16, fp16), in fp32
template <int DP, typename H>
__device__ __forceinline__ std::enable_if_t<!kIsF32<H>, float> row_dot(
    const H* x, const H* y) {
  static_assert(DP % 8 == 0, "16-byte loads tile the row");
  using H2 = std::conditional_t<kIsF16<H>, __half2, __nv_bfloat162>;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < DP; c += 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(x + c);
    const uint4 b = *reinterpret_cast<const uint4*>(y + c);
    const H2* a2 = reinterpret_cast<const H2*>(&a);
    const H2* b2 = reinterpret_cast<const H2*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = to_float2(a2[i]);
      const float2 fb = to_float2(b2[i]);
      s[i] = fmaf(fa.y, fb.y, fmaf(fa.x, fb.x, s[i]));
    }
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// strided attention tensors
// ---------------------------------------------------------------------------

struct Layout {  // element strides of one tensor; lanes are contiguous
  long long b, h, t;
};

// every row of the tensor starts 16-byte aligned (es: bytes an element)
inline bool rows16(const void* p, const Layout& l, int es) {
  const long long e = 16 / es;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && l.b % e == 0 &&
         l.h % e == 0 && l.t % e == 0;
}

// x rounded to the input dtype (the second argument's type) and back
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_to(float x, __half) {
  return __half2float(__float2half_rn(x));
}

// c += X.Y^T over DP lanes for a warp's 16 rows of X (from row m0), both
// padded tiles of T: split TF32 in fp32, the 16-bit type's tensor cores in
// bf16 and fp16
template <int NB, int DP, typename T>
__device__ __forceinline__ void gemm_abT(float (&c)[NB][4], const T* X,
                                         int m0, const T* Y) {
  constexpr int SW = stride<T>(DP);
  if constexpr (kIsF32<T>)
    gemm_abT_tf32<NB, DP, SW, SW, false, false>(c, X, m0, Y);
  else
    gemm_abT16<NB, DP, SW>(c, X, m0, Y);
}

// write a warp's 16 x DP accumulator times mul into rows r0.. (< nrows)
// of a strided tensor, lanes < D
template <int DP, typename T>
__device__ __forceinline__ void store_rows(T* base, long long row_stride,
                                           const float (&acc)[DP / 8][4],
                                           float mul, int r0, int nrows,
                                           int D) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= nrows) continue;
    T* p = base + row * row_stride;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < D) store(p + c, acc[n][2 * r] * mul);
      if (c + 1 < D) store(p + c + 1, acc[n][2 * r + 1] * mul);
    }
  }
}

// dynamic shared memory above 48 KB, granted once per kernel and device
// (each instantiation of a kernel uses one size)
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

}  // namespace tc
