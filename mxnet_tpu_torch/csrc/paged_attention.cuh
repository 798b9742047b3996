// Shared body of the paged attention kernels for Hopper (sm_90a):
// paged_attention_decode.cu (B2), paged_attention_decode_quant.cu (B3)
// and paged_attention_verify.cu (B4, raw and quantized pages).
//
// attend() is the work of one thread block for one (stream, head, query
// row): one query at position len-1 against the first len cached tokens
// of the stream, read through its block-table row.  Every kernel runs
// this one function, so a verify row w at len = start+1+w executes the
// same instructions on the same bytes as the decode kernel at lengths =
// start+1+w, and the two agree bit for bit (the JAX package's "verify
// row == decode step" contract, rebuilt between the port's kernels).
//
// * Eight warps; warp w takes pages w, w+8, ... (pages at or past
//   ceil(len / KVB) are never read, slots at or past len inside the last
//   page are masked); each lane holds DP/32 lanes of q and of the
//   accumulator, DP the head-width bucket (32, 64, 96 or 128).  A head
//   width below its bucket (Ragged) masks the lanes past D: they load
//   nothing, hold zeros and are not stored.  At D = DP the lane count is a
//   constant and the code is the unmasked one.  Eight tokens are in flight per warp (independent loads
//   and butterfly reductions) before one online-softmax update.
// * The eight warps' (m, l, acc) states merge through shared memory at
//   the end; a warp that saw no page contributes nothing, and len == 0
//   gives zeros, never NaN.
// * A page reader turns one (slot, head) row of the pools into fp32:
//   RawPages reads fp32/bf16 values, QuantPages int8/fp8-e4m3 codes times
//   the row's fp32 scale (the scale is read once per token; the 32 lanes
//   of a warp read the same word, one broadcast transaction).  Rows are
//   numbered r = (page * KVB + slot) * H + head, so values start at r * D
//   and the (P, KVB, H) scale pools hold one float at r.
// * The readers take the pools by value and read them with plain loads
//   through __restrict__ pointers, and the body addresses a token as
//   page base + slot * H * D: the decode kernel's code before the body
//   was shared.  A reference to the reader and __ldg loads with the
//   offset recomputed from r made the decode kernel 30-60% slower on the
//   H100 (PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace paged {

constexpr int NW = 8;  // warps per block
constexpr int U = 8;   // tokens in flight per warp
constexpr int kMaxHeadDim = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// int8 codes are signed char, fp8-e4m3 codes unsigned char
// (__nv_fp8_storage_t)
__device__ __forceinline__ float to_f32(signed char x) { return (float)x; }
__device__ __forceinline__ float to_f32(unsigned char x) {
  // every e4m3 value is exact in fp16, and fp16 in fp32
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, __NV_E4M3)));
}

// A reader gets each token-head row twice over: ``off``, the element
// offset of this lane's first value (the decode kernel's addressing),
// and ``r``, the row's index, which addresses its scale; ``n`` of this
// lane's DPL values exist (DPL, a constant, unless the head is ragged),
// the rest read as zero.
template <typename TKV>
struct RawPages {
  const TKV* __restrict__ k;
  const TKV* __restrict__ v;
  template <int DPL>
  __device__ __forceinline__ void key(long off, long r, int n,
                                      float (&x)[DPL]) const {
#pragma unroll
    for (int i = 0; i < DPL; ++i) x[i] = i < n ? to_f32(k[off + i]) : 0.f;
  }
  template <int DPL>
  __device__ __forceinline__ void value(long off, long r, int n,
                                        float (&x)[DPL]) const {
#pragma unroll
    for (int i = 0; i < DPL; ++i) x[i] = i < n ? to_f32(v[off + i]) : 0.f;
  }
};

// dequantized as float(code) * scale right after the load, as the TPU
// kernel does (_paged_decode_quant_kernel)
template <typename TC>
struct QuantPages {
  const TC* __restrict__ k;
  const TC* __restrict__ v;
  const float* __restrict__ ks;
  const float* __restrict__ vs;
  template <int DPL>
  __device__ __forceinline__ void key(long off, long r, int n,
                                      float (&x)[DPL]) const {
    const float sc = ks[r];
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      x[i] = i < n ? to_f32(k[off + i]) * sc : 0.f;
  }
  template <int DPL>
  __device__ __forceinline__ void value(long off, long r, int n,
                                        float (&x)[DPL]) const {
    const float sc = vs[r];
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      x[i] = i < n ? to_f32(v[off + i]) * sc : 0.f;
  }
};

// One block (NW warps): q row at position len-1 of head h against the
// stream's first len tokens; writes D values at orow.  DP: D's bucket;
// Ragged: D < DP.
template <typename TQ, int DP, bool Ragged, typename Pages>
__device__ __forceinline__ void attend(const TQ* __restrict__ qrow,
                                       const Pages pages,
                                       const int* __restrict__ table_row,
                                       int len, int h, int H, int D_,
                                       int KVB, int MB, float scale,
                                       TQ* __restrict__ orow) {
  constexpr int DPL = DP / 32;  // head lanes per thread
  const int D = Ragged ? D_ : DP;  // a constant in the addressing at D = DP
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int npages = len > 0 ? min((len + KVB - 1) / KVB, MB) : 0;
  // this lane's head lanes that exist
  const int nv = Ragged ? max(0, min(DPL, D - lane * DPL)) : DPL;

  float qr[DPL];
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    qr[i] = i < nv ? to_f32(qrow[lane * DPL + i]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  const long tok_stride = (long)H * D;
  for (int j = warp; j < npages; j += NW) {
    const int page = table_row[j];
    const int tmax = min(KVB, len - j * KVB);  // live slots of this page
    const long rbase = (long)page * KVB * H + h;  // row of slot 0
    const long pbase = rbase * D + lane * DPL;
    for (int t0 = 0; t0 < tmax; t0 += U) {
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d = 0.f;
        if (t0 + u < tmax) {
          float kx[DPL];
          pages.key(pbase + (long)(t0 + u) * tok_stride,
                    rbase + (long)(t0 + u) * H, nv, kx);
#pragma unroll
          for (int i = 0; i < DPL; ++i) d = fmaf(qr[i], kx[i], d);
        }
        s[u] = d;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      }
      float mt = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (t0 + u >= tmax) s[u] = -INFINITY;
        mt = fmaxf(mt, s[u]);
      }
      const float m_new = fmaxf(m, mt);  // finite: slot t0 is live
      const float alpha = expf(m - m_new);
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = expf(s[u] - m_new);
        ps += s[u];
      }
      l = l * alpha + ps;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (t0 + u < tmax) {
          float vx[DPL];
          pages.value(pbase + (long)(t0 + u) * tok_stride,
                      rbase + (long)(t0 + u) * H, nv, vx);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[i] = fmaf(s[u], vx[i], acc[i]);
        }
      }
      m = m_new;
    }
  }

  __shared__ float sm_m[NW];
  __shared__ float sm_l[NW];
  __shared__ float sm_acc[NW][DP];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) sm_acc[warp][lane * DPL + i] = acc[i];
  __syncthreads();

  if (warp == 0) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w]);
    float L = 0.f;
    float A[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) A[i] = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - M);
      L = fmaf(sm_l[w], f, L);
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        A[i] = fmaf(sm_acc[w][lane * DPL + i], f, A[i]);
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);  // L == 0 -> zeros
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (i < nv) orow[lane * DPL + i] = from_f32<TQ>(A[i] * inv);
  }
}

// Decode: grid (B, H); block (b, h) attends lengths[b] tokens.  q may be
// a strided view (the query third of the packed qkv): batch stride
// q_batch_stride, head and lane strides D and 1.  out is (B, H, D).
template <typename TQ, int DP, bool Ragged, typename Pages>
__global__ void __launch_bounds__(NW * 32)
decode_kernel(const TQ* __restrict__ q, long q_batch_stride, Pages pages,
              const int* __restrict__ table,
              const int* __restrict__ lengths, TQ* __restrict__ out, int H,
              int D_, int KVB, int MB, float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int D = Ragged ? D_ : DP;
  attend<TQ, DP, Ragged>(q + (long)b * q_batch_stride + (long)h * D, pages,
                         table + (long)b * MB, lengths[b], h, H, D, KVB, MB,
                         scale, out + ((long)b * H + h) * D);
}

// Verify: grid (B, H, W); block (b, h, w) attends start[b] + 1 + w
// tokens (the diagonal mask k_pos < start + 1 + w).  q (B, W, H, D) may
// be strided: batch and row strides given, head and lane strides D and
// 1.  out is (B, W, H, D).
template <typename TQ, int DP, bool Ragged, typename Pages>
__global__ void __launch_bounds__(NW * 32)
verify_kernel(const TQ* __restrict__ q, long q_batch_stride,
              long q_row_stride, Pages pages,
              const int* __restrict__ table, const int* __restrict__ start,
              TQ* __restrict__ out, int W, int H, int D_, int KVB, int MB,
              float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int w = blockIdx.z;
  const int D = Ragged ? D_ : DP;
  attend<TQ, DP, Ragged>(q + (long)b * q_batch_stride +
                             (long)w * q_row_stride + (long)h * D,
                         pages, table + (long)b * MB, start[b] + 1 + w, h, H,
                         D, KVB, MB, scale,
                         out + (((long)b * W + w) * H + h) * D);
}

template <int N>
using Int = std::integral_constant<int, N>;

// launch(Int<DP>{}, std::bool_constant<Ragged>{}) for D's bucket: the
// launchers' one dispatch on the head width, so the decode and verify
// kernels run the same instantiation of attend at every D
template <typename F>
cudaError_t with_head_dim(int D, F&& launch) {
  using std::false_type;
  using std::true_type;
  if (D < 1 || D > kMaxHeadDim) return cudaErrorInvalidValue;
  if (D <= 32)
    return D == 32 ? launch(Int<32>{}, false_type{})
                   : launch(Int<32>{}, true_type{});
  if (D <= 64)
    return D == 64 ? launch(Int<64>{}, false_type{})
                   : launch(Int<64>{}, true_type{});
  if (D <= 96)
    return D == 96 ? launch(Int<96>{}, false_type{})
                   : launch(Int<96>{}, true_type{});
  return D == 128 ? launch(Int<128>{}, false_type{})
                  : launch(Int<128>{}, true_type{});
}

}  // namespace paged
