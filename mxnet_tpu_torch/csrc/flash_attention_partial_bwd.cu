// Flash attention, un-normalized partial state, backward, for Hopper
// (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:flash_attention_bwd (its two
// Pallas kernels _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel over
// _flash_bwd_p, the backward of flash_attention_partial under every ring
// hop).  Same function: from q (B, Tq, H, D), k and v (B, Tk, H, D), the
// forward's row max m (B, H, Tq) float32 and the cotangents ob of o
// (B, H, Tq, D) and lb of l (B, H, Tq), both float32, with m held constant
// (every consumer of the partial state is invariant under (o, m, l) ->
// (o e^-c, m + c, l e^-c), so m's cotangent cancels exactly), rebuild
//   p_ij = exp(q_i.k_j*scale - m_safe_i)  under the forward's masks
// (m_safe = 0 where m = -inf: such a row saw no key and p is 0) and form
//   ds = p * (ob.v^T + lb),
//   dq = ds.k*scale,  dk = ds^T.q*scale,  dv = p^T.ob   (no scale),
// each in its input's dtype.  This is not flash_mha_bwd: there is no
// lse, no Delta = rowsum(do*o), and lb enters with a plus sign.  ds is
// rounded to k's (q's) dtype before dq's (dk's) product, as the TPU kernels
// cast it; p meets ob in float32, as there.
//
// Layout: q, k, v, dq, dk and dv through their own (batch, head, row)
// element strides, lanes contiguous (BTHD tensors need no transpose copy);
// ob, m and lb are contiguous.
//
// What bounds it on the H100: the work.  A ring hop at (1, 12, 4096, 4096,
// 64) with nothing masked is ~7.7e10 FLOP (dq) and ~1.0e11 (dk/dv) against
// ~70 MB of traffic (fp32), far above the memory line at fp32's CUDA-core
// rate.  This first version runs its products on the CUDA cores in fp32 (no
// wgmma/TMA yet).
//
// Design (that of flash_mha_bwd.cu):
// * Two kernels, as on the TPU.  dq: a block owns 64 query rows and walks
//   the key tiles.  dk/dv: a block owns 64 key rows and walks the query
//   tiles (kv-block-outer).  Each output row is owned by one block and
//   written once: no atomics, and the gradients are deterministic.
// * Four threads share a row, each holding W = DP/4 contiguous lanes in
//   registers (dq: q, ob and the dq accumulator; dk/dv: k, v and both
//   accumulators; DP: D rounded up to a multiple of 32, lanes past D zero);
//   a row's dot products finish with two xor-shuffles.
// * The streamed operand (K and V tiles for dq; Q and ob tiles, with each
//   row's m and lb, for dk/dv) is staged in shared memory as fp32, 32 rows
//   at a time, and read as float4; the four parts of a staged row sit 4
//   words apart, and the rows of a warp broadcast.
// * Causal with the key offset koff (key j visible to row i when j + koff
//   <= i): dq stops at the last key its last valid row can see; dk/dv
//   starts at the first query tile that can see its first key, and a key
//   block no query sees writes zeros without loading anything.
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

// m in the exp2 domain, 0 for a row that saw no key (m = -inf)
__device__ __forceinline__ float m_safe2(float m) {
  return m == -INFINITY ? 0.f : m * LOG2E;
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
partial_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ m,
                      const float* __restrict__ ob,
                      const float* __restrict__ lb, T* __restrict__ dq,
                      Layout lq, Layout lk, Layout lv, Layout ldq, int H,
                      int Tq, int Tk, int D, int causal, int koff,
                      float scale) {
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

  const long long st = ((long long)b * H + h) * Tq + qrow;
  float qr[W], obr[W], acc[W];
  load_lanes<T, W>(qr, q + b * lq.b + h * lq.h + qrow * lq.t, l0, D, live);
  load_lanes<float, W>(obr, ob + st * D, l0, D, live);
#pragma unroll
  for (int c = 0; c < W; ++c) acc[c] = 0.f;
  const float m2 = live ? m_safe2(m[st]) : 0.f;
  const float lbr = live ? lb[st] : 0.f;
  const float c1 = scale * LOG2E;

  int k_end = Tk;
  if (causal) {
    const long long last = (long long)min(q0 + ROWS, Tq) - 1 - koff + 1;
    k_end = (int)max(0LL, min((long long)Tk, last));
  }
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
      const float ov = row_sum(part_dot<W>(obr, &Vs[j][sc0]));
      const bool ok =
          live && (!causal || (long long)(k0 + j) + koff <= qi);
      const float p = ok ? exp2f(s * c1 - m2) : 0.f;
      const float ds = round_to<T>(p * (ov + lbr));  // ds in k's dtype
      part_axpy<W>(acc, ds, &Ks[j][sc0]);
    }
  }

  if (live)
    store_lanes<T, W>(dq + b * ldq.b + h * ldq.h + (long long)qi * ldq.t,
                      acc, scale, l0, D);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
partial_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ m,
                       const float* __restrict__ ob,
                       const float* __restrict__ lb, T* __restrict__ dk,
                       T* __restrict__ dv, Layout lq, Layout lk, Layout lv,
                       Layout ldk, Layout ldv, int H, int Tq, int Tk, int D,
                       int causal, int koff, float scale) {
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
  const long long st0 = ((long long)b * H + h) * Tq;
  const float* obb = ob + st0 * D;

  __shared__ __align__(16) float Qs[TILE][SW];
  __shared__ __align__(16) float Os[TILE][SW];
  __shared__ float Ms[TILE];  // m_safe of each staged row, exp2 domain
  __shared__ float Lb[TILE];  // lb of each staged row

  float kv[W], vv[W], dka[W], dva[W];
  load_lanes<T, W>(kv, k + b * lk.b + h * lk.h + krow * lk.t, l0, D, live);
  load_lanes<T, W>(vv, v + b * lv.b + h * lv.h + krow * lv.t, l0, D, live);
#pragma unroll
  for (int c = 0; c < W; ++c) {
    dka[c] = 0.f;
    dva[c] = 0.f;
  }
  const float c1 = scale * LOG2E;

  // causal: the first query that can see this block's first key sits at
  // k0 + koff; query tiles wholly before it are skipped (64-bit: koff may
  // be any int), and past Tq - 1 the loop does not run at all
  int q_begin = 0;
  if (causal) {
    const long long first = (long long)k0 + koff;
    q_begin = first <= 0 ? 0
              : (int)min((long long)Tq, (first / TILE) * TILE);
  }
  for (int qs = q_begin; qs < Tq; qs += TILE) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < TILE * DP; idx += NT) {
      const int r = idx / DP;
      const int c = idx % DP;
      const int qr = qs + r;
      float qx = 0.f, ox = 0.f;
      if (qr < Tq && c < D) {
        qx = to_f32(qb[(long long)qr * lq.t + c]);
        ox = obb[(long long)qr * D + c];
      }
      Qs[r][c + (c / W) * PAD] = qx;
      Os[r][c + (c / W) * PAD] = ox;
    }
    if (threadIdx.x < TILE) {
      const int qr = qs + threadIdx.x;
      Ms[threadIdx.x] = qr < Tq ? m_safe2(m[st0 + qr]) : 0.f;
      Lb[threadIdx.x] = qr < Tq ? lb[st0 + qr] : 0.f;
    }
    __syncthreads();
    const int jn = min(TILE, Tq - qs);  // the same for the whole block
    for (int j = 0; j < jn; ++j) {
      const float s = row_sum(part_dot<W>(kv, &Qs[j][sc0]));
      const float ov = row_sum(part_dot<W>(vv, &Os[j][sc0]));
      const bool ok =
          live && (!causal || (long long)kr + koff <= qs + j);
      const float p = ok ? exp2f(s * c1 - Ms[j]) : 0.f;
      part_axpy<W>(dva, p, &Os[j][sc0]);               // p meets ob in fp32
      const float ds = round_to<T>(p * (ov + Lb[j]));  // ds in q's dtype
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
  const void *q, *k, *v, *m, *ob, *lb;
  void *dq, *dk, *dv;
  Layout ls[5];  // q, k, v, then dq (dq kernel) or dk, dv (dk/dv kernel)
  int B, H, Tq, Tk, D, causal, koff;
};

template <typename T, int DP>
void launch_dp(int which, const Args& a, cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)a.D);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const float* m = static_cast<const float*>(a.m);
  const float* ob = static_cast<const float*>(a.ob);
  const float* lb = static_cast<const float*>(a.lb);
  if (which == 0) {
    const dim3 grid((a.Tq + ROWS - 1) / ROWS, a.H, a.B);
    partial_bwd_dq_kernel<T, DP><<<grid, NT, 0, stream>>>(
        q, k, v, m, ob, lb, static_cast<T*>(a.dq), a.ls[0], a.ls[1],
        a.ls[2], a.ls[3], a.H, a.Tq, a.Tk, a.D, a.causal, a.koff, scale);
  } else {
    const dim3 grid((a.Tk + ROWS - 1) / ROWS, a.H, a.B);
    partial_bwd_dkv_kernel<T, DP><<<grid, NT, 0, stream>>>(
        q, k, v, m, ob, lb, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        a.ls[0], a.ls[1], a.ls[2], a.ls[3], a.ls[4], a.H, a.Tq, a.Tk, a.D,
        a.causal, a.koff, scale);
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

// strides: 12 element strides, (batch, head, row) of q, k, v and dq.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and dq share it); m and lb
// (B, H, Tq) and ob (B, H, Tq, D) are float32 and contiguous.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* m,
                                      const void* ob, const void* lb,
                                      void* dq, const long long* strides,
                                      int B, int H, int Tq, int Tk, int D,
                                      int causal, int kv_offset, int dtype,
                                      void* stream) {
  Args a{q, k, v, m, ob, lb, dq, nullptr, nullptr, {},
         B, H, Tq, Tk, D, causal, kv_offset};
  return dispatch(0, a, strides, 4, dtype, stream);
}

// strides: 15 element strides, (batch, head, row) of q, k, v, dk and dv;
// the rest as flash_attention_bwd_dq.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* m,
                                       const void* ob, const void* lb,
                                       void* dk, void* dv,
                                       const long long* strides, int B,
                                       int H, int Tq, int Tk, int D,
                                       int causal, int kv_offset, int dtype,
                                       void* stream) {
  Args a{q, k, v, m, ob, lb, nullptr, dk, dv, {},
         B, H, Tq, Tk, D, causal, kv_offset};
  return dispatch(1, a, strides, 5, dtype, stream);
}
