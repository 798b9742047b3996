// Paged decode attention for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:paged_attention_decode (the
// Pallas kernel _paged_decode_kernel with its page fold _paged_fold_page).
// Same function: one query per stream, q (B, H, D) at position lengths-1,
// against K/V pages (P, KVB, H, D) gathered through the block table
// (B, MB) int32; pages at or past ceil(lengths/KVB) are never read, slots
// at or past lengths inside the last page are masked, the softmax runs in
// fp32, and a stream with lengths == 0 gets zeros, never NaN.
//
// What bounds it on the H100: bytes.  Each cached token's K and V row is
// read once and used for 2*D multiply-adds each, about 0.5 FLOP a byte in
// fp32, so the floor is the pages' bytes over 3.35 TB/s.
//
// Design:
// * One thread block per (stream, head), eight warps.  The block reads
//   block_table[b, j] itself (this replaces the TPU's scalar prefetch) and
//   walks only pages j < ceil(lengths[b] / KVB): the table's padding out to
//   the cache bucket (page 0, the scratch page) is never touched.
// * Warp w takes pages w, w+8, ...; each lane holds D/32 of the head's
//   lanes of q and of the accumulator.  Eight tokens are in flight per warp
//   (independent loads and butterfly reductions) before one online-softmax
//   update, so a warp does not wait on one row's load at a time.
// * The eight warps' partial states (m, l, acc) merge through shared memory
//   at the end; a warp that saw no page contributes nothing.
// * q may be a strided view (the query third of the packed qkv): its batch
//   stride is an argument, its head and lane strides are D and 1.
// * Built for D = 64 (D/32 head lanes a thread), the head width served so
//   far; another multiple of 32 is one more case in launch().
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

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

constexpr int NW = 8;  // warps per block
constexpr int U = 8;   // tokens in flight per warp

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(NW * 32)
paged_decode_kernel(const TQ* __restrict__ q, long q_batch_stride,
                    const TKV* __restrict__ kp, const TKV* __restrict__ vp,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, TQ* __restrict__ out,
                    int H, int KVB, int MB, float scale) {
  constexpr int DPL = D / 32;  // head lanes per thread
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int len = lengths[b];
  const int npages = len > 0 ? min((len + KVB - 1) / KVB, MB) : 0;

  float qr[DPL];
  float acc[DPL];
  {
    const TQ* qrow = q + (long)b * q_batch_stride + (long)h * D + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      qr[i] = to_f32(qrow[i]) * scale;
      acc[i] = 0.f;
    }
  }
  float m = -INFINITY;
  float l = 0.f;

  const long tok_stride = (long)H * D;
  for (int j = warp; j < npages; j += NW) {
    const int page = table[(long)b * MB + j];
    const int tmax = min(KVB, len - j * KVB);  // live slots of this page
    const long pbase = ((long)page * KVB * H + h) * D + lane * DPL;
    for (int t0 = 0; t0 < tmax; t0 += U) {
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d = 0.f;
        if (t0 + u < tmax) {
          const TKV* kr = kp + pbase + (long)(t0 + u) * tok_stride;
#pragma unroll
          for (int i = 0; i < DPL; ++i) d = fmaf(qr[i], to_f32(kr[i]), d);
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
          const TKV* vr = vp + pbase + (long)(t0 + u) * tok_stride;
#pragma unroll
          for (int i = 0; i < DPL; ++i)
            acc[i] = fmaf(s[u], to_f32(vr[i]), acc[i]);
        }
      }
      m = m_new;
    }
  }

  __shared__ float sm_m[NW];
  __shared__ float sm_l[NW];
  __shared__ float sm_acc[NW][D];
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
    TQ* orow = out + ((long)b * H + h) * D + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) orow[i] = from_f32<TQ>(A[i] * inv);
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, long qs, const void* kp, const void* vp,
                   const int* table, const int* lengths, void* out, int B,
                   int H, int D, int KVB, int MB, cudaStream_t stream) {
  const dim3 grid(B, H);
  const float scale = 1.f / sqrtf((float)D);
  const TQ* qq = static_cast<const TQ*>(q);
  const TKV* k = static_cast<const TKV*>(kp);
  const TKV* v = static_cast<const TKV*>(vp);
  TQ* o = static_cast<TQ*>(out);
  switch (D) {
    case 64:
      paged_decode_kernel<TQ, TKV, 64><<<grid, NW * 32, 0, stream>>>(
          qq, qs, k, v, table, lengths, o, H, KVB, MB, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16.  Supported pairs: (0, 0),
// (0, 1) (fp32 model over bf16 pages) and (1, 1).  out has q's dtype.
extern "C" int paged_attention_decode(const void* q, long q_batch_stride,
                                      const void* k_pool,
                                      const void* v_pool, const void* table,
                                      const void* lengths, void* out, int B,
                                      int H, int D, int KVB, int MB,
                                      int q_dtype, int kv_dtype,
                                      void* stream) {
  if (B < 1 || H < 1 || KVB < 1 || MB < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* n = static_cast<const int*>(lengths);
  if (q_dtype == 0 && kv_dtype == 0)
    return (int)launch<float, float>(q, q_batch_stride, k_pool, v_pool, t, n,
                                     out, B, H, D, KVB, MB, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(q, q_batch_stride, k_pool,
                                             v_pool, t, n, out, B, H, D, KVB,
                                             MB, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        q, q_batch_stride, k_pool, v_pool, t, n, out, B, H, D, KVB, MB, s);
  return (int)cudaErrorInvalidValue;
}
