// Normalized multi-head flash attention, backward, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:_mha_bwd (its two Pallas
// kernels _mha_bwd_dq_kernel and _mha_bwd_dkv_kernel, the backward of
// flash_mha under DotProductAttention).  Same function: from q (B, H, Tq,
// D), k and v (B, H, Tk, D), the forward's lse (B, H, Tq), the output
// cotangent do (B, H, Tq, D) and Delta = rowsum(do * o) (B, H, Tq), both
// float32 and computed outside the kernels as the JAX code does, rebuild
// p = exp(q.k^T*scale - lse) under the mask k_pos <= q_pos (causal,
// aligned at position 0) and form
//   ds = p * (do.v^T - Delta),
//   dq = ds.k*scale,  dk = ds^T.q*scale,  dv = p^T.do,
// each in its input's dtype.  p is rounded to do's dtype before dv's
// product and ds to k's (q's) dtype before dq's (dk's), as the TPU kernels
// cast them.  D up to kMaxHeadDim, Tq and Tk free, tails included.
//
// Layout: every tensor through its own (batch, head, row) element strides,
// lanes contiguous (BTHD and BHTD views alike, no transpose copy); dq, dk
// and dv are written through theirs (the wrapper gives them the inputs'
// layouts).  lse and Delta are contiguous.
//
// What bounds it on the H100: the work.  At B=8, H=12, T=1024, D=64,
// causal, the two kernels do ~4.5e10 FLOP against ~200 MB of traffic
// (fp32), far above the memory line at fp32's CUDA-core rate.  This first
// version runs its products on the CUDA cores in fp32 (no wgmma/TMA yet).
//
// Design:
// * Two kernels, as on the TPU.  dq: a block owns 64 query rows and walks
//   the key tiles.  dk/dv: a block owns 64 key rows and walks the query
//   tiles (kv-block-outer, the TPU grid (BH, nk, nq)).  Each output row is
//   owned by one block and written once: no atomics, and the gradients
//   are deterministic.
// * Four threads share a row, each holding W = DP/4 contiguous lanes in
//   registers (dq: q, do and the dq accumulator; dk/dv: k, v and both
//   accumulators; DP: D rounded up to a multiple of 32, lanes past D
//   zero); a row's dot products finish with two xor-shuffles.
// * The streamed operand (K and V tiles for dq; Q and dO tiles, with each
//   row's lse and Delta, for dk/dv) is staged in shared memory as fp32, 32
//   rows at a time, and read as float4; the four parts of a staged row sit
//   4 words apart (no bank conflicts), and the rows of a warp broadcast.
// * Causal: dq stops at the last key tile touching the diagonal; dk/dv
//   starts at the first query tile touching it, and a key block past every
//   query writes zeros without loading anything.
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxHeadDim = 128;
constexpr int TPR = 4;          // threads sharing one row
constexpr int ROWS = 64;        // output rows a block owns
constexpr int NT = ROWS * TPR;  // threads per block
constexpr int TILE = 32;        // streamed rows per shared-memory tile
constexpr int PAD = 4;          // words between the parts of a staged row
constexpr float LOG2E = 1.4426950408889634f;

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

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// dot product of a thread's W register lanes with its lanes of a staged
// row (not yet summed over the row's threads)
template <int W>
__device__ __forceinline__ float part_dot(const float* r, const float* s) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
  float d = 0.f;
#pragma unroll
  for (int c = 0; c < W / 4; ++c) {
    const float4 x = s4[c];
    d = fmaf(r[4 * c], x.x, d);
    d = fmaf(r[4 * c + 1], x.y, d);
    d = fmaf(r[4 * c + 2], x.z, d);
    d = fmaf(r[4 * c + 3], x.w, d);
  }
  return d;
}

// acc += a * (a thread's lanes of a staged row)
template <int W>
__device__ __forceinline__ void part_axpy(float* acc, float a,
                                          const float* s) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
  for (int c = 0; c < W / 4; ++c) {
    const float4 x = s4[c];
    acc[4 * c] = fmaf(a, x.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(a, x.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(a, x.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(a, x.w, acc[4 * c + 3]);
  }
}

// a thread's W lanes of one row of a tensor (zero past D or for a dead row)
template <typename T, int W>
__device__ __forceinline__ void load_lanes(float* r, const T* row, int l0,
                                           int D, bool live) {
#pragma unroll
  for (int c = 0; c < W; ++c)
    r[c] = (live && l0 + c < D) ? to_f32(row[l0 + c]) : 0.f;
}

template <typename T, int W>
__device__ __forceinline__ void store_lanes(T* row, const float* r, float mul,
                                            int l0, int D) {
#pragma unroll
  for (int c = 0; c < W; ++c)
    if (l0 + c < D) row[l0 + c] = from_f32<T>(r[c] * mul);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq,
                  Layout lq, Layout lk, Layout lv, Layout ldo, Layout ldq,
                  int H, int Tq, int Tk, int D, int causal, float scale) {
  constexpr int W = DP / TPR;
  constexpr int SW = DP + TPR * PAD;
  static_assert(W % 4 == 0, "a thread's lanes are read as float4");
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const int l0 = part * W;
  const int sc0 = part * (W + PAD);
  const int q0 = blockIdx.x * ROWS;
  const int qi = q0 + row;
  const bool live = qi < Tq;
  const long long qrow = live ? qi : 0;
  const T* kb = k + b * lk.b + h * lk.h;
  const T* vb = v + b * lv.b + h * lv.h;

  __shared__ __align__(16) float Ks[TILE][SW];
  __shared__ __align__(16) float Vs[TILE][SW];

  float qr[W], dor[W], acc[W];
  load_lanes<T, W>(qr, q + b * lq.b + h * lq.h + qrow * lq.t, l0, D, live);
  load_lanes<T, W>(dor, dout + b * ldo.b + h * ldo.h + qrow * ldo.t, l0, D,
                   live);
#pragma unroll
  for (int c = 0; c < W; ++c) acc[c] = 0.f;
  const long long st = ((long long)b * H + h) * Tq + qrow;
  const float lse2 = live ? lse[st] * LOG2E : 0.f;
  const float dl = live ? delta[st] : 0.f;
  const float c1 = scale * LOG2E;

  const int k_end = causal ? min(Tk, q0 + ROWS) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < TILE * DP; idx += NT) {
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
    const int jn = min(TILE, k_end - k0);  // the same for the whole block
    for (int j = 0; j < jn; ++j) {
      const float s = row_sum(part_dot<W>(qr, &Ks[j][sc0]));
      const float dp = row_sum(part_dot<W>(dor, &Vs[j][sc0]));
      const bool ok = live && (!causal || k0 + j <= qi);
      const float p = ok ? exp2f(s * c1 - lse2) : 0.f;
      const float ds = round_to<T>(p * (dp - dl));  // ds in k's dtype
      part_axpy<W>(acc, ds, &Ks[j][sc0]);
    }
  }

  if (live)
    store_lanes<T, W>(dq + b * ldq.b + h * ldq.h + (long long)qi * ldq.t,
                      acc, scale, l0, D);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
mha_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, Layout lq, Layout lk, Layout lv,
                   Layout ldo, Layout ldk, Layout ldv, int H, int Tq, int Tk,
                   int D, int causal, float scale) {
  constexpr int W = DP / TPR;
  constexpr int SW = DP + TPR * PAD;
  static_assert(W % 4 == 0, "a thread's lanes are read as float4");
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const int l0 = part * W;
  const int sc0 = part * (W + PAD);
  const int k0 = blockIdx.x * ROWS;
  const int kr = k0 + row;
  const bool live = kr < Tk;
  const long long krow = live ? kr : 0;
  const T* qb = q + b * lq.b + h * lq.h;
  const T* db = dout + b * ldo.b + h * ldo.h;
  const long long st0 = ((long long)b * H + h) * Tq;

  __shared__ __align__(16) float Qs[TILE][SW];
  __shared__ __align__(16) float Ds[TILE][SW];
  __shared__ float Ls[TILE];  // lse of each staged row, exp2 domain
  __shared__ float Dl[TILE];  // Delta of each staged row

  float kv[W], vv[W], dka[W], dva[W];
  load_lanes<T, W>(kv, k + b * lk.b + h * lk.h + krow * lk.t, l0, D, live);
  load_lanes<T, W>(vv, v + b * lv.b + h * lv.h + krow * lv.t, l0, D, live);
#pragma unroll
  for (int c = 0; c < W; ++c) {
    dka[c] = 0.f;
    dva[c] = 0.f;
  }
  const float c1 = scale * LOG2E;

  // query tiles wholly above the diagonal see none of this block's keys
  for (int qs = causal ? (k0 / TILE) * TILE : 0; qs < Tq; qs += TILE) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < TILE * DP; idx += NT) {
      const int r = idx / DP;
      const int c = idx % DP;
      const int qr = qs + r;
      float qx = 0.f, dx = 0.f;
      if (qr < Tq && c < D) {
        qx = to_f32(qb[(long long)qr * lq.t + c]);
        dx = to_f32(db[(long long)qr * ldo.t + c]);
      }
      Qs[r][c + (c / W) * PAD] = qx;
      Ds[r][c + (c / W) * PAD] = dx;
    }
    if (threadIdx.x < TILE) {
      const int qr = qs + threadIdx.x;
      Ls[threadIdx.x] = qr < Tq ? lse[st0 + qr] * LOG2E : 0.f;
      Dl[threadIdx.x] = qr < Tq ? delta[st0 + qr] : 0.f;
    }
    __syncthreads();
    const int jn = min(TILE, Tq - qs);  // the same for the whole block
    for (int j = 0; j < jn; ++j) {
      const float s = row_sum(part_dot<W>(kv, &Qs[j][sc0]));
      const float dp = row_sum(part_dot<W>(vv, &Ds[j][sc0]));
      const bool ok = live && (!causal || qs + j >= kr);
      const float p = ok ? exp2f(s * c1 - Ls[j]) : 0.f;
      part_axpy<W>(dva, round_to<T>(p), &Ds[j][sc0]);  // p in do's dtype
      const float ds = round_to<T>(p * (dp - Dl[j]));   // ds in q's dtype
      part_axpy<W>(dka, ds, &Qs[j][sc0]);
    }
  }

  if (live) {
    store_lanes<T, W>(dk + b * ldk.b + h * ldk.h + (long long)kr * ldk.t,
                      dka, scale, l0, D);
    store_lanes<T, W>(dv + b * ldv.b + h * ldv.h + (long long)kr * ldv.t,
                      dva, 1.f, l0, D);
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  Layout ls[6];  // q, k, v, do, then dq (dq kernel) or dk, dv (dk/dv kernel)
  int B, H, Tq, Tk, D, causal;
};

template <typename T, int DP>
void launch_dp(int which, const Args& a, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)a.D);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* d = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  if (which == 0) {
    const dim3 grid((a.Tq + ROWS - 1) / ROWS, a.H, a.B);
    mha_bwd_dq_kernel<T, DP><<<grid, NT, 0, stream>>>(
        q, k, v, d, lse, delta, static_cast<T*>(a.dq), a.ls[0], a.ls[1],
        a.ls[2], a.ls[3], a.ls[4], a.H, a.Tq, a.Tk, a.D, a.causal, scale);
  } else {
    const dim3 grid((a.Tk + ROWS - 1) / ROWS, a.H, a.B);
    mha_bwd_dkv_kernel<T, DP><<<grid, NT, 0, stream>>>(
        q, k, v, d, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        a.ls[0], a.ls[1], a.ls[2], a.ls[3], a.ls[4], a.ls[5], a.H, a.Tq,
        a.Tk, a.D, a.causal, scale);
  }
}

template <typename T>
cudaError_t launch(int which, const Args& a, cudaStream_t s) {
  if (a.D <= 32)
    launch_dp<T, 32>(which, a, s);
  else if (a.D <= 64)
    launch_dp<T, 64>(which, a, s);
  else if (a.D <= 96)
    launch_dp<T, 96>(which, a, s);
  else
    launch_dp<T, 128>(which, a, s);
  return cudaGetLastError();
}

int dispatch(int which, Args& a, const long long* strides, int nlayouts,
             int dtype, void* stream) {
  if (a.B < 1 || a.H < 1 || a.Tq < 1 || a.Tk < 1 || a.D < 1 ||
      a.D > kMaxHeadDim || a.B > 65535 || a.H > 65535)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nlayouts; ++i)
    a.ls[i] = Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(which, a, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(which, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: 15 element strides, (batch, head, row) of q, k, v, do and dq.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do and dq share it); lse and
// delta are float32 (B, H, Tq), contiguous.
extern "C" int flash_mha_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq,
                                const long long* strides, int B, int H,
                                int Tq, int Tk, int D, int causal, int dtype,
                                void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, {},
         B, H, Tq, Tk, D, causal};
  return dispatch(0, a, strides, 5, dtype, stream);
}

// strides: 18 element strides, (batch, head, row) of q, k, v, do, dk and
// dv; the rest as flash_mha_bwd_dq.
extern "C" int flash_mha_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 const long long* strides, int B, int H,
                                 int Tq, int Tk, int D, int causal, int dtype,
                                 void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, {},
         B, H, Tq, Tk, D, causal};
  return dispatch(1, a, strides, 6, dtype, stream);
}
