// Flash attention, un-normalized partial state, forward, for Hopper
// (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:flash_attention_partial (the
// Pallas kernel _flash_kernel behind blockwise_attention_partial: every hop
// of mxnet_tpu.sequence.ring_attention and the decode-time layout of
// ulysses_attention).  Same function: q (B, Tq, H, D), k and v (B, Tk, H, D),
// any head width D up to kMaxHeadDim, Tq and Tk free (tails masked, never
// padded), and a key offset koff = (absolute position of k[0]) - (absolute
// position of q[0]) →
//   o (B, H, Tq, D) float32, UN-normalized: sum_j p_ij v_j,
//   m (B, H, Tq) float32, the row max of the scaled scores (natural units),
//   l (B, H, Tq) float32, sum_j p_ij,
// with p_ij = exp(q_i.k_j/sqrt(D) - m_i) over the visible keys: all of them,
// or under the causal mask those with j + koff <= i.  A row that sees no key
// comes out as m = -inf, l = 0, o = 0 exactly (the ring's merge tests
// isfinite(m)).  Scores and the state are float32; p is rounded to v's dtype
// before the PV product, as the TPU kernel casts it; the outputs are float32
// for bf16 inputs too.
//
// Layout: q, k and v are addressed through their own (batch, head, row)
// element strides, lanes contiguous, so (B, H, T, D) views of the BTHD
// tensors need no transpose copy.  o, m and l are contiguous.
//
// What bounds it on the H100: the work.  A ring hop at (1, 12, 4096, 4096,
// 64) with nothing masked is ~5.2e10 FLOP against ~38 MB of traffic (fp32),
// far above the memory line at fp32's CUDA-core rate.  This first kernel
// runs its products on the CUDA cores in fp32 (no wgmma/TMA yet), so its
// ceiling is the 67 TFLOP/s fp32 rate.
//
// Design (that of flash_mha.cu, which computes the normalized function):
// * One block of 256 threads per (64 query rows, head, batch row).  Four
//   threads share a query row, each holding W = DP/4 contiguous lanes of q
//   and of the accumulator in registers (DP: D rounded up to a multiple of
//   32, lanes past D zero); a row's dot products finish with two
//   xor-shuffles.
// * K and V tiles of 32 rows are staged in shared memory as fp32 (bf16
//   widened on load) and read as float4; the four parts of a staged row sit
//   4 words apart (no bank conflicts), and the rows of a warp broadcast.
// * The loop over key tiles replaces the TPU grid's sequential kj axis.
//   Causal: the last key a block can see is its last VALID row's position
//   minus koff, so tiles past it are never loaded, and a block that sees no
//   key at all (a positive koff past its rows) only writes the empty state.
// * Scores live in the exp2 domain (q pre-scaled by log2(e)/sqrt(D)); m is
//   written back in natural units (times ln 2).
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
partial_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   Layout lq, Layout lk, Layout lv, int H, int Tq, int Tk,
                   int D, int causal, int koff, float scale_log2) {
  constexpr int W = DP / TPR;         // lanes a thread holds
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

  // causal: key j is visible to row i when j + koff <= i, so no row of this
  // block sees a key at or past (last valid row) - koff + 1 (64-bit: koff
  // may be any int)
  int k_end = Tk;
  if (causal) {
    const long long last = (long long)min(q0 + BQ, Tq) - 1 - koff + 1;
    k_end = (int)max(0LL, min((long long)Tk, last));
  }
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
      const bool ok =
          j < jn && (!causal || (long long)(k0 + j) + koff <= qi);
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
    const long long st = ((long long)b * H + h) * Tq + qi;
    float* dst = o + st * D;
#pragma unroll
    for (int c = 0; c < W; ++c)
      if (l0 + c < D) dst[l0 + c] = acc[c];
    if (part == 0) {
      m_out[st] = m * LN2;  // -inf stays -inf
      l_out[st] = l;
    }
  }
}

template <typename T, int DP>
void launch_dp(const void* q, const void* k, const void* v, void* o, void* m,
               void* l, const Layout* ls, int B, int H, int Tq, int Tk,
               int D, int causal, int koff, cudaStream_t stream) {
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  const float scale_log2 = LOG2E / sqrtf((float)D);
  partial_fwd_kernel<T, DP><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), ls[0], ls[1], ls[2],
      H, Tq, Tk, D, causal, koff, scale_log2);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* m, void* l, const Layout* ls, int B, int H, int Tq,
                   int Tk, int D, int causal, int koff, cudaStream_t s) {
  if (D <= 32)
    launch_dp<T, 32>(q, k, v, o, m, l, ls, B, H, Tq, Tk, D, causal, koff, s);
  else if (D <= 64)
    launch_dp<T, 64>(q, k, v, o, m, l, ls, B, H, Tq, Tk, D, causal, koff, s);
  else if (D <= 96)
    launch_dp<T, 96>(q, k, v, o, m, l, ls, B, H, Tq, Tk, D, causal, koff, s);
  else
    launch_dp<T, 128>(q, k, v, o, m, l, ls, B, H, Tq, Tk, D, causal, koff,
                      s);
  return cudaGetLastError();
}

}  // namespace

// strides: 9 element strides, (batch, head, row) of q, k and v in that
// order.  dtype: 0 = float32, 1 = bfloat16 (q, k and v share it); o
// (B, H, Tq, D), m and l (B, H, Tq) are float32 and contiguous.
extern "C" int flash_attention_partial_fwd(
    const void* q, const void* k, const void* v, void* o, void* m, void* l,
    const long long* strides, int B, int H, int Tq, int Tk, int D,
    int causal, int kv_offset, int dtype, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 1 || D > kMaxHeadDim ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Layout ls[3];
  for (int i = 0; i < 3; ++i)
    ls[i] = Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, m, l, ls, B, H, Tq, Tk, D, causal,
                              kv_offset, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, m, l, ls, B, H, Tq, Tk, D,
                                      causal, kv_offset, s);
  return (int)cudaErrorInvalidValue;
}
