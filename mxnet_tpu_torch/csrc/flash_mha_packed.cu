// Packed-QKV flash attention, forward, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:_mhap_fwd (the Pallas kernel
// _mhap_fwd_kernel behind flash_mha_packed).  Same function: attention read
// straight off the fused QKV projection output qkv (B, T, 3*H*D), laid out
// [q | k | v] with head h on lanes [h*D, (h+1)*D) of each third, written
// straight into o (B, T, H*D) with no transposes, plus the log-sum-exp of
// each row for the backward.
//
// What bounds it on the H100: the work.  Causal attention at T=1024, H=12,
// D=64 is ~1.6 GFLOP against ~12.6 MB of traffic (fp32), about 127 FLOP a
// byte, far above the memory line at fp32's CUDA-core rate.  This first
// kernel runs its products on the CUDA cores in fp32 (no wgmma/TMA yet),
// so its ceiling is the 67 TFLOP/s fp32 rate, not the tensor cores'.
//
// Design:
// * One thread block per (q-tile of 64 rows, head, batch row); one thread
//   per query row keeps q, the output accumulator and the online-softmax
//   state (m, l) in registers.  The loop over k-tiles inside the block takes
//   the place of the TPU grid's sequential kj axis.
// * K and V tiles of 32 rows are staged in shared memory as fp32 (bf16 is
//   widened on load); every thread of the block reads the same K/V element
//   at once, a shared-memory broadcast.
// * Scores live in the exp2 domain (q is pre-scaled by log2(e)/sqrt(D)) as
//   in the TPU kernel.  Causal blocks stop at the last k-tile touching the
//   diagonal: tiles wholly above it are never loaded.
// * lse is written as (B, T, H) float32 in natural-log units; the TPU
//   kernel's is log2 and broadcast over D.
// * Built for D = 64, the head width of the transformer_lm configurations
//   served so far (a wider head would spill this design's registers).
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

constexpr int BQ = 64;  // query rows per block, one per thread
constexpr int BK = 32;  // key rows per shared-memory tile
constexpr float LN2 = 0.6931471805599453f;

template <typename T, int D>
__global__ void __launch_bounds__(BQ)
mhap_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ o,
                float* __restrict__ lse, int T_, int H, int causal,
                float scale_log2) {
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int HD = H * D;
  const long rs = 3L * HD;  // elements between consecutive tokens
  const T* base = qkv + (long)b * T_ * rs;

  __shared__ __align__(16) float Ks[BK][D];
  __shared__ __align__(16) float Vs[BK][D];

  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + threadIdx.x;
  const bool live = qi < T_;

  float q[D];
  float acc[D];
  {
    const T* qrow = base + (long)(live ? qi : 0) * rs + h * D;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      q[c] = live ? to_f32(qrow[c]) * scale_log2 : 0.f;
      acc[c] = 0.f;
    }
  }
  float m = -INFINITY;
  float l = 0.f;

  const int q_last = min(T_, q0 + BQ) - 1;
  const int k_end = causal ? q_last + 1 : T_;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < BK * D; idx += BQ) {
      const int r = idx / D;
      const int c = idx % D;
      const int kr = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kr < T_) {
        const T* row = base + (long)kr * rs + h * D + c;
        kx = to_f32(row[HD]);
        vx = to_f32(row[2 * HD]);
      }
      Ks[r][c] = kx;
      Vs[r][c] = vx;
    }
    __syncthreads();

    float s[BK];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) d = fmaf(q[c], Ks[j][c], d);
      const int kr = k0 + j;
      const bool ok = kr < T_ && (!causal || kr <= qi);
      s[j] = ok ? d : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    if (m_new == -INFINITY) continue;  // nothing visible to this row yet
    const float alpha = exp2f(m - m_new);  // 0 while m is still -inf
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = exp2f(s[j] - m_new);  // masked entries give exactly 0
      ps += s[j];
    }
    l = l * alpha + ps;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(s[j], Vs[j][c], acc[c]);
    }
    m = m_new;
  }

  if (live) {
    const float lsafe = fmaxf(l, 1e-30f);
    const float inv = 1.f / lsafe;
    T* orow = o + ((long)b * T_ + qi) * HD + h * D;
#pragma unroll
    for (int c = 0; c < D; ++c) orow[c] = from_f32<T>(acc[c] * inv);
    lse[((long)b * T_ + qi) * H + h] = (m + log2f(lsafe)) * LN2;
  }
}

template <typename T>
cudaError_t launch(const void* qkv, void* o, void* lse, int B, int T_,
                   int H, int D, int causal, cudaStream_t stream) {
  const dim3 grid((T_ + BQ - 1) / BQ, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  const T* in = static_cast<const T*>(qkv);
  T* out = static_cast<T*>(o);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 64:
      mhap_fwd_kernel<T, 64><<<grid, BQ, 0, stream>>>(in, out, l, T_, H,
                                                      causal, scale_log2);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (qkv and o share it; lse is float32).
extern "C" int flash_mha_packed_fwd(const void* qkv, void* o, void* lse,
                                    int B, int T, int H, int D, int causal,
                                    int dtype, void* stream) {
  if (B < 1 || T < 1 || H < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(qkv, o, lse, B, T, H, D, causal, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(qkv, o, lse, B, T, H, D, causal, s);
  return (int)cudaErrorInvalidValue;
}
