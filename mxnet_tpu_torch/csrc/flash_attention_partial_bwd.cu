// Flash attention, un-normalized partial state, backward, for Hopper
// (sm_90a), on the tensor cores.
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
// lse, no Delta = rowsum(do*o), and lb enters with a plus sign.
//
// Rounding, as the TPU kernels': every product accumulates in fp32.
//   q.k^T   fp32: split TF32 (3 products); bf16/fp16: its tensor cores
//   ob.v^T  fp32 x v: split TF32, 3 products in fp32, 2 in bf16 and
//           fp16 (v is exact in TF32)
//   p^T.ob  p stays fp32 (p.astype(ob.dtype)): split TF32, 3 products
//   ds.k, ds^T.q  ds rounded to the input dtype first; fp32: split TF32,
//           bf16/fp16: its tensor cores
// (tensor_core.cuh holds the split, the fragments and the cp.async ring.)
//
// Layout: q, k, v, dq, dk and dv through their own (batch, head, row)
// element strides, lanes contiguous (BTHD tensors need no transpose copy);
// ob, m and lb are contiguous.
//
// What bounds it on the H100: the work.  A ring hop at (1, 12, 4096, 4096,
// 64) with nothing masked is ~7.7e10 FLOP (dq) and ~1.0e11 (dk/dv) against
// ~70 MB of traffic (fp32), far above the memory line.  Split TF32 runs
// three TF32 products for each fp32 one: 165 TFLOP/s in effect.
//
// Design (FlashAttention-2's backward on mma.sync; why mma.sync and not
// wgmma: flash_mha_packed.cu):
// * Two kernels, as on the TPU.  dq: a block of 4 warps owns 64 query rows
//   (16 a warp) and walks the key tiles; S = Q.K^T and dP = ob.V^T sit in
//   accumulator fragments, and dS goes straight from them into the A
//   operand of dQ += dS.K.  dk/dv: a block owns 64 key rows and walks the
//   query tiles (kv-block-outer); it computes S^T = K.Q^T and dP^T =
//   V.ob^T, so P^T and dS^T sit in the accumulators as the A operands of
//   dV += P^T.ob and dK += dS^T.q.  Each output row is owned by one warp
//   and written once: no atomics, and the gradients are deterministic.
// * The block's own rows (Q and ob for dq; K and V for dk/dv) are staged
//   once; the streamed tiles (K and V; Q, ob, m and lb) come through a
//   two-stage cp.async ring, one barrier a tile.  16-byte copies where
//   every row of every tensor is 16-byte aligned (the C entry decides per
//   launch), else one element a thread: the same kernel either way.
// * Streamed tiles: dq 64 key rows for D <= 64 and 32 above; dk/dv 32 query
//   rows and 16 above, which keeps the accumulators of D = 128 (dk/dv: two
//   16 x 128 a warp) in registers.  Outputs that sum over the streamed
//   rows take each tile's products in a fresh accumulator
//   (tc::gemm_pY_acc): the tensor cores' accumulation does not round to
//   nearest, and a chain over thousands of rows drifts.
// * Masks (causal with the key offset koff: key j visible to row i when
//   j + koff <= i; the Tq and Tk tails) on the fragments.  dq stops at the
//   last key its last valid row can see; dk/dv starts at the first query
//   tile that can see its first key, and a key block no query sees writes
//   zeros without loading anything.
// Every entry point returns cudaGetLastError() after its launch.

#include "tensor_core.cuh"

namespace {

constexpr int kMaxHeadDim = 128;
constexpr int ROWS = 64;  // output rows a block owns, 16 a warp
constexpr int NT = 128;   // threads per block
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

using tc::Layout;
using tc::round_to;
using tc::rows16;
using tc::store_rows;

template <typename T, int DP>
struct Cfg {
  static constexpr int SW = tc::stride<T>(DP);  // q, k, v tiles
  static constexpr int SWF = DP + 4;            // ob tiles (fp32)
  static constexpr int BN = DP <= 64 ? 64 : 32;  // dq: key rows per tile
  static constexpr int BM = DP <= 64 ? 32 : 16;  // dk/dv: query rows per tile
  // dq: Q, ob, then STAGES x (K, V)
  static constexpr int DQ_SMEM =
      ROWS * SW * (int)sizeof(T) + ROWS * SWF * 4 +
      STAGES * 2 * BN * SW * (int)sizeof(T);
  // dk/dv: K, V, then STAGES x (Q, ob, m, lb)
  static constexpr int STAGE_DKV = BM * SW * (int)sizeof(T) + BM * SWF * 4 +
                                   2 * BM * 4;
  static constexpr int DKV_SMEM =
      2 * ROWS * SW * (int)sizeof(T) + STAGES * STAGE_DKV;
};

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
                      float scale, int vec16) {
  using C = Cfg<T, DP>;
  constexpr int SW = C::SW, SWF = C::SWF, BN = C::BN;
  constexpr bool F32 = tc::kIsF32<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  float* Obs = reinterpret_cast<float*>(Qs + ROWS * SW);
  T* KV = reinterpret_cast<T*>(Obs + ROWS * SWF);  // [STAGES][K, V][BN][SW]

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5;
  const int g = tc::lane_id() >> 2, t = tc::lane_id() & 3;
  const T* qb = q + b * lq.b + h * lq.h;
  const T* kb = k + b * lk.b + h * lk.h;
  const T* vb = v + b * lv.b + h * lv.h;
  const long long st0 = ((long long)b * H + h) * Tq;

  int k_end = Tk;
  if (causal) {
    const long long last = (long long)min(q0 + ROWS, Tq) - 1 - koff + 1;
    k_end = (int)max(0LL, min((long long)Tk, last));
  }
  const int nk = (k_end + BN - 1) / BN;

  // this thread's rows row0 and row0 + 8: m, lb and the causal limit
  // (key j visible when j <= lim, computed in 64 bits: koff is any int)
  const int row0 = q0 + warp * 16 + g;
  float m2[2], lbr[2];
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool live = row < Tq;
    m2[r] = live ? m_safe2(m[st0 + row]) : 0.f;
    lbr[r] = live ? lb[st0 + row] : 0.f;
    const long long l64 = causal ? (long long)row - koff : (long long)Tk;
    lim[r] = !live ? -1 : (int)max(-1LL, min((long long)Tk - 1, l64));
  }

  float acc[DP / 8][4];
  tc::zero(acc);
  if (nk > 0) {
    tc::stage<T, ROWS, DP, SW, NT>(Qs, qb, lq.t, q0, Tq, D, vec16);
    tc::stage<float, ROWS, DP, SWF, NT>(Obs, ob + st0 * D, D, q0, Tq, D,
                                        vec16);
    tc::stage<T, BN, DP, SW, NT>(KV, kb, lk.t, 0, k_end, D, vec16);
    tc::stage<T, BN, DP, SW, NT>(KV + BN * SW, vb, lv.t, 0, k_end, D, vec16);
  }
  tc::cp_async_commit();
  const float c1 = scale * LOG2E;

  for (int it = 0; it < nk; ++it) {
    // one barrier a tile: tile it has landed for every thread, and every
    // thread is done with the stage the next copy refills
    tc::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < nk) {
      T* nxt = KV + ((it + 1) % STAGES) * 2 * BN * SW;
      tc::stage<T, BN, DP, SW, NT>(nxt, kb, lk.t, (it + 1) * BN, k_end, D,
                                   vec16);
      tc::stage<T, BN, DP, SW, NT>(nxt + BN * SW, vb, lv.t, (it + 1) * BN,
                                   k_end, D, vec16);
    }
    tc::cp_async_commit();
    const T* Ks = KV + (it % STAGES) * 2 * BN * SW;
    const T* Vs = Ks + BN * SW;
    const int k0 = it * BN;

    // S = Q.K^T, then P (fp32) under the masks
    float s[BN / 8][4];
    tc::zero(s);
    tc::gemm_abT<BN / 8, DP>(s, Qs, warp * 16, Ks);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + j * 8 + 2 * t + (i & 1);
        s[j][i] = col <= lim[i >> 1] ? exp2f(s[j][i] * c1 - m2[i >> 1]) : 0.f;
      }

    // dP = ob.V^T; dS = P * (dP + lb), in the inputs' dtype
    float dp[BN / 8][4];
    tc::zero(dp);
    tc::gemm_abT_tf32<BN / 8, DP, SWF, SW, false, !F32>(dp, Obs, warp * 16,
                                                        Vs);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dp[j][i] = round_to(s[j][i] * (dp[j][i] + lbr[i >> 1]), T());

    // dQ += dS.K
    tc::gemm_pY_acc<BN / 8, DP / 8, SW, !F32>(acc, dp, Ks);
  }

  store_rows<DP>(dq + b * ldq.b + h * ldq.h, ldq.t, acc, scale,
                 q0 + warp * 16, Tq, D);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
partial_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ m,
                       const float* __restrict__ ob,
                       const float* __restrict__ lb, T* __restrict__ dk,
                       T* __restrict__ dv, Layout lq, Layout lk, Layout lv,
                       Layout ldk, Layout ldv, int H, int Tq, int Tk, int D,
                       int causal, int koff, float scale, int vec16) {
  using C = Cfg<T, DP>;
  constexpr int SW = C::SW, SWF = C::SWF, BM = C::BM;
  constexpr bool F32 = tc::kIsF32<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + ROWS * SW;
  unsigned char* ring = reinterpret_cast<unsigned char*>(Vs + ROWS * SW);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5;
  const int g = tc::lane_id() >> 2, t = tc::lane_id() & 3;
  const T* qb = q + b * lq.b + h * lq.h;
  const long long st0 = ((long long)b * H + h) * Tq;
  const float* obb = ob + st0 * D;
  const float* mb = m + st0;
  const float* lbb = lb + st0;

  // causal: the first query that can see this block's first key sits at
  // k0 + koff; query tiles wholly before it are skipped (64-bit: koff may
  // be any int), and past Tq - 1 the loop does not run at all
  int q_begin = 0;
  if (causal) {
    const long long first = (long long)k0 + koff;
    q_begin = first <= 0 ? 0 : (int)min((long long)Tq, (first / BM) * BM);
  }
  const int nt = (Tq - q_begin + BM - 1) / BM;

  // this thread's keys key0 and key0 + 8: query i sees the key when
  // i >= lim (Tq: never)
  const int key0 = k0 + warp * 16 + g;
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    const long long l64 = causal ? (long long)key + koff : 0LL;
    lim[r] = key >= Tk ? Tq : (int)max(0LL, min((long long)Tq, l64));
  }

  auto stage_q = [&](int s, int qs) {
    unsigned char* p = ring + s * C::STAGE_DKV;
    T* Qt = reinterpret_cast<T*>(p);
    float* Ot = reinterpret_cast<float*>(Qt + BM * SW);
    float* Mt = Ot + BM * SWF;
    tc::stage<T, BM, DP, SW, NT>(Qt, qb, lq.t, qs, Tq, D, vec16);
    tc::stage<float, BM, DP, SWF, NT>(Ot, obb, D, qs, Tq, D, vec16);
    for (int i = threadIdx.x; i < 2 * BM; i += NT) {
      const int r = i % BM;
      const bool ok = qs + r < Tq;
      const float* src = i < BM ? mb : lbb;
      tc::cp_async4(Mt + i, ok ? src + qs + r : src, ok ? 4 : 0);
    }
  };

  float dka[DP / 8][4], dva[DP / 8][4];
  tc::zero(dka);
  tc::zero(dva);
  if (nt > 0) {
    tc::stage<T, ROWS, DP, SW, NT>(Ks, k + b * lk.b + h * lk.h, lk.t, k0, Tk,
                                   D, vec16);
    tc::stage<T, ROWS, DP, SW, NT>(Vs, v + b * lv.b + h * lv.h, lv.t, k0, Tk,
                                   D, vec16);
    stage_q(0, q_begin);
  }
  tc::cp_async_commit();
  const float c1 = scale * LOG2E;

  for (int it = 0; it < nt; ++it) {
    const int qs = q_begin + it * BM;
    tc::cp_async_wait<0>();  // one barrier a tile, as in the dq kernel
    __syncthreads();
    if (it + 1 < nt) stage_q((it + 1) % STAGES, qs + BM);
    tc::cp_async_commit();
    const unsigned char* p = ring + (it % STAGES) * C::STAGE_DKV;
    const T* Qt = reinterpret_cast<const T*>(p);
    const float* Ot = reinterpret_cast<const float*>(Qt + BM * SW);
    const float* Mt = Ot + BM * SWF;
    const float* Lt = Mt + BM;

    // S^T = K.Q^T, then P^T (fp32) under the masks
    float s[BM / 8][4];
    tc::zero(s);
    tc::gemm_abT<BM / 8, DP>(s, Ks, warp * 16, Qt);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * t + e;  // query qs + c
        const float mq = m_safe2(Mt[c]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool ok = qs + c >= lim[r] && qs + c < Tq;
          float& x = s[j][2 * r + e];
          x = ok ? exp2f(x * c1 - mq) : 0.f;
        }
      }

    // dV += P^T.ob (p in fp32)
    tc::gemm_pY_acc<BM / 8, DP / 8, SWF, false>(dva, s, Ot);

    // dP^T = V.ob^T; dS^T = P^T * (dP^T + lb), in the inputs' dtype
    float dp[BM / 8][4];
    tc::zero(dp);
    tc::gemm_abT_tf32<BM / 8, DP, SW, SWF, !F32, false>(dp, Vs, warp * 16, Ot);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float lq_ = Lt[j * 8 + 2 * t + (i & 1)];
        dp[j][i] = round_to(s[j][i] * (dp[j][i] + lq_), T());
      }

    // dK += dS^T.q
    tc::gemm_pY_acc<BM / 8, DP / 8, SW, !F32>(dka, dp, Qt);
  }

  store_rows<DP>(dk + b * ldk.b + h * ldk.h, ldk.t, dka, scale,
                 k0 + warp * 16, Tk, D);
  store_rows<DP>(dv + b * ldv.b + h * ldv.h, ldv.t, dva, 1.f,
                 k0 + warp * 16, Tk, D);
}

struct Args {
  const void *q, *k, *v, *m, *ob, *lb;
  void *dq, *dk, *dv;
  Layout ls[5];  // q, k, v, then dq (dq kernel) or dk, dv (dk/dv kernel)
  int B, H, Tq, Tk, D, causal, koff;
};

template <typename T, int DP>
cudaError_t launch_dp(int which, const Args& a, cudaStream_t stream) {
  using C = Cfg<T, DP>;
  const float scale = 1.f / sqrtf((float)a.D);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const float* m = static_cast<const float*>(a.m);
  const float* ob = static_cast<const float*>(a.ob);
  const float* lb = static_cast<const float*>(a.lb);
  // 16-byte staging when every staged row of q, k, v and ob is aligned
  const int es = (int)sizeof(T);
  const int vec16 = rows16(q, a.ls[0], es) && rows16(k, a.ls[1], es) &&
                    rows16(v, a.ls[2], es) &&
                    reinterpret_cast<uintptr_t>(ob) % 16 == 0 &&
                    a.D % 4 == 0;
  cudaError_t e;
  if (which == 0) {
    e = tc::allow_smem<&partial_bwd_dq_kernel<T, DP>>(C::DQ_SMEM);
    if (e != cudaSuccess) return e;
    const dim3 grid((a.Tq + ROWS - 1) / ROWS, a.H, a.B);
    partial_bwd_dq_kernel<T, DP><<<grid, NT, C::DQ_SMEM, stream>>>(
        q, k, v, m, ob, lb, static_cast<T*>(a.dq), a.ls[0], a.ls[1],
        a.ls[2], a.ls[3], a.H, a.Tq, a.Tk, a.D, a.causal, a.koff, scale,
        vec16);
  } else {
    e = tc::allow_smem<&partial_bwd_dkv_kernel<T, DP>>(C::DKV_SMEM);
    if (e != cudaSuccess) return e;
    const dim3 grid((a.Tk + ROWS - 1) / ROWS, a.H, a.B);
    partial_bwd_dkv_kernel<T, DP><<<grid, NT, C::DKV_SMEM, stream>>>(
        q, k, v, m, ob, lb, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        a.ls[0], a.ls[1], a.ls[2], a.ls[3], a.ls[4], a.H, a.Tq, a.Tk, a.D,
        a.causal, a.koff, scale, vec16);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int which, const Args& a, cudaStream_t s) {
  if (a.D <= 32) return launch_dp<T, 32>(which, a, s);
  if (a.D <= 64) return launch_dp<T, 64>(which, a, s);
  if (a.D <= 96) return launch_dp<T, 96>(which, a, s);
  return launch_dp<T, 128>(which, a, s);
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
  if (dtype == 2) return (int)launch<__half>(which, a, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int smem_of(int which, int D) {
  const bool dq = which == 0;
  if (D <= 32) return dq ? Cfg<T, 32>::DQ_SMEM : Cfg<T, 32>::DKV_SMEM;
  if (D <= 64) return dq ? Cfg<T, 64>::DQ_SMEM : Cfg<T, 64>::DKV_SMEM;
  if (D <= 96) return dq ? Cfg<T, 96>::DQ_SMEM : Cfg<T, 96>::DKV_SMEM;
  return dq ? Cfg<T, 128>::DQ_SMEM : Cfg<T, 128>::DKV_SMEM;
}

}  // namespace

// strides: 12 element strides, (batch, head, row) of q, k, v and dq.
// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and dq share it);
// m and lb (B, H, Tq) and ob (B, H, Tq, D) are float32 and contiguous.
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

// dynamic shared memory a block takes (which: 0 = dq, 1 = dk/dv; dtype
// as above), for chip_smoke.py's resource report
extern "C" int flash_attention_bwd_smem_bytes(int which, int D, int dtype) {
  return dtype == 0   ? smem_of<float>(which, D)
         : dtype == 1 ? smem_of<__nv_bfloat16>(which, D)
                      : smem_of<__half>(which, D);
}
