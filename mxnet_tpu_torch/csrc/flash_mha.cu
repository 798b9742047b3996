// Normalized multi-head flash attention, forward, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:_mha_fwd (the Pallas kernel
// _mha_fwd_kernel behind flash_mha, the attention of DotProductAttention).
// Same function: q (B, H, Tq, D), k and v (B, H, Tk, D), three separate
// tensors of any head width D up to kMaxHeadDim, Tq and Tk free (tails
// included), causal mask k_pos <= q_pos aligned at position 0 (a row with
// q_pos >= Tk sees every key) →
//   o (B, H, Tq, D) in q's dtype, normalized in-kernel, and
//   lse (B, H, Tq) float32, natural log: m + log(max(l, 1e-30)).
// Scores and the online-softmax state are float32; p is rounded to v's
// dtype before the PV product, as the TPU kernel casts it.
//
// Layout: every tensor is addressed through its own (batch, head, row)
// element strides, lanes contiguous.  blockwise_attention hands the kernel
// BTHD and BHTD views alike, with no transpose copy; o is written through
// its own strides (the wrapper gives it q's layout).  lse is contiguous.
//
// What bounds it on the H100: the work.  Causal attention at B=8, H=12,
// T=1024, D=64 is ~13 GFLOP against ~100 MB (fp32), ~130 FLOP a byte, far
// above the memory line at fp32's CUDA-core rate.  This first kernel runs
// its products on the CUDA cores in fp32 (no wgmma/TMA yet), so its
// ceiling is the 67 TFLOP/s fp32 rate.
//
// Design:
// * One block of 256 threads per (64 query rows, head, batch row).  Four
//   threads share a query row, each holding W = DP/4 contiguous lanes of q
//   and of the output accumulator in registers (DP: D rounded up to a
//   multiple of 32; lanes past D are zero), so D = 128 keeps 2 x 32 floats
//   a thread where a row per thread would spill.  A row's dot products
//   finish with two xor-shuffles.
// * K and V tiles of 32 rows are staged in shared memory as fp32 (bf16
//   widened on load).  A thread reads its lanes of a staged row as float4;
//   the four parts of a row sit 4 words apart, so the four 16-byte reads of
//   a row fall in different banks, and the 8 rows of a warp read the same
//   words (broadcast).
// * The loop over key tiles takes the place of the TPU grid's sequential
//   kj axis.  Causal blocks stop at the last key tile touching the
//   diagonal: tiles wholly above it are never loaded.
// * Scores live in the exp2 domain (q pre-scaled by log2(e)/sqrt(D)).
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxHeadDim = 128;
constexpr int TPR = 4;          // threads sharing one query row
constexpr int BQ = 64;          // query rows a block owns
constexpr int NT = BQ * TPR;    // threads per block
constexpr int BK = 32;          // key rows per shared-memory tile
constexpr int PAD = 4;          // words between the parts of a staged row
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Layout {  // element strides of one tensor; lanes are contiguous
  long long b, h, t;
};

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

// x rounded to T's precision, back in float32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// sum over the TPR threads of one row (adjacent lanes of one warp)
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, Layout lq, Layout lk, Layout lv,
               Layout lo, int H, int Tq, int Tk, int D, int causal,
               float scale_log2) {
  constexpr int W = DP / TPR;       // lanes a thread holds
  constexpr int SW = DP + TPR * PAD;  // shared row width (words)
  static_assert(W % 4 == 0, "a thread's lanes are read as float4");
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const int l0 = part * W;            // first lane this thread holds
  const int sc0 = part * (W + PAD);   // its first shared column
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + row;
  const bool live = qi < Tq;
  const T* kb = k + b * lk.b + h * lk.h;
  const T* vb = v + b * lv.b + h * lv.h;

  __shared__ __align__(16) float Ks[BK][SW];
  __shared__ __align__(16) float Vs[BK][SW];

  float qr[W];
  float acc[W];
  {
    const T* src = q + b * lq.b + h * lq.h + (long long)(live ? qi : 0) * lq.t;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const int lane = l0 + c;
      qr[c] = (live && lane < D) ? to_f32(src[lane]) * scale_log2 : 0.f;
      acc[c] = 0.f;
    }
  }
  float m = -INFINITY;
  float l = 0.f;

  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < BK * DP; idx += NT) {
      const int r = idx / DP;
      const int c = idx % DP;
      const int kr = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kr < k_end && c < D) {
        kx = to_f32(kb[(long long)kr * lk.t + c]);
        vx = to_f32(vb[(long long)kr * lv.t + c]);
      }
      Ks[r][c + (c / W) * PAD] = kx;
      Vs[r][c + (c / W) * PAD] = vx;
    }
    __syncthreads();
    const int jn = min(BK, k_end - k0);

    float s[BK];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr4 = reinterpret_cast<const float4*>(&Ks[j][sc0]);
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < W / 4; ++c) {
        const float4 x = kr4[c];
        d = fmaf(qr[4 * c], x.x, d);
        d = fmaf(qr[4 * c + 1], x.y, d);
        d = fmaf(qr[4 * c + 2], x.z, d);
        d = fmaf(qr[4 * c + 3], x.w, d);
      }
      d = row_sum(d);
      const bool ok = j < jn && (!causal || k0 + j <= qi);
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
    for (int c = 0; c < W; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = round_to<T>(s[j]);  // p in v's dtype, as on the TPU
      const float4* vr4 = reinterpret_cast<const float4*>(&Vs[j][sc0]);
#pragma unroll
      for (int c = 0; c < W / 4; ++c) {
        const float4 x = vr4[c];
        acc[4 * c] = fmaf(p, x.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(p, x.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, x.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, x.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
  }

  if (live) {
    const float lsafe = fmaxf(l, 1e-30f);
    const float inv = 1.f / lsafe;
    T* dst = o + b * lo.b + h * lo.h + (long long)qi * lo.t;
#pragma unroll
    for (int c = 0; c < W; ++c)
      if (l0 + c < D) dst[l0 + c] = from_f32<T>(acc[c] * inv);
    if (part == 0)
      lse[((long long)b * H + h) * Tq + qi] = (m + log2f(lsafe)) * LN2;
  }
}

template <typename T, int DP>
void launch_dp(const void* q, const void* k, const void* v, void* o,
               void* lse, const Layout* ls, int B, int H, int Tq, int Tk,
               int D, int causal, cudaStream_t stream) {
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  const float scale_log2 = LOG2E / sqrtf((float)D);
  mha_fwd_kernel<T, DP><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), ls[0], ls[1], ls[2], ls[3], H, Tq, Tk, D,
      causal, scale_log2);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, const Layout* ls, int B, int H, int Tq, int Tk,
                   int D, int causal, cudaStream_t s) {
  if (D <= 32)
    launch_dp<T, 32>(q, k, v, o, lse, ls, B, H, Tq, Tk, D, causal, s);
  else if (D <= 64)
    launch_dp<T, 64>(q, k, v, o, lse, ls, B, H, Tq, Tk, D, causal, s);
  else if (D <= 96)
    launch_dp<T, 96>(q, k, v, o, lse, ls, B, H, Tq, Tk, D, causal, s);
  else
    launch_dp<T, 128>(q, k, v, o, lse, ls, B, H, Tq, Tk, D, causal, s);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, head, row) of q, k, v and o in that
// order.  dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it; lse is
// float32 (B, H, Tq), contiguous).
extern "C" int flash_mha_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const long long* strides,
                             int B, int H, int Tq, int Tk, int D, int causal,
                             int dtype, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || D > kMaxHeadDim ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Layout ls[4];
  for (int i = 0; i < 4; ++i)
    ls[i] = Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, lse, ls, B, H, Tq, Tk, D, causal,
                              s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, lse, ls, B, H, Tq, Tk, D,
                                      causal, s);
  return (int)cudaErrorInvalidValue;
}
