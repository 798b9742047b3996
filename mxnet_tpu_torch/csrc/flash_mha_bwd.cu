// Normalized multi-head flash attention, backward, for Hopper (sm_90a), on
// the tensor cores.
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
// each in its input's dtype.  D up to kMaxHeadDim, Tq and Tk free, tails
// included.
//
// Rounding, as the TPU kernels': every product accumulates in fp32.  fp32:
// all five products (q.k^T, do.v^T, ds.k, ds^T.q, p^T.do) as split TF32,
// three tensor-core products each (tensor_core.cuh).  bf16 and fp16: all
// five on the type's tensor cores, p rounded to do's dtype before p^T.do and ds to k's
// (q's) dtype before ds.k (ds^T.q), as the TPU kernels cast them.
//
// Layout: q, k, v, do, dq, dk and dv through their own (batch, head, row)
// element strides, lanes contiguous (BTHD and BHTD views alike, no
// transpose copy; the wrapper gives the gradients the inputs' layouts).
// lse and Delta are contiguous.
//
// What bounds it on the H100: the work.  At B=8, H=12, T=1024, D=64,
// causal, the two kernels do ~4.5e10 FLOP against ~200 MB of traffic
// (fp32), far above the memory line.  Split TF32 runs three TF32 products
// for each fp32 one: 165 TFLOP/s in effect; bf16 and fp16 up to 989.
//
// Design (B9's, flash_attention_partial_bwd.cu, with lse in place of m and
// -Delta in place of +lb; B1's backward, flash_mha_packed_bwd.cu, is the
// same arithmetic on the packed layout with Delta in-kernel):
// * Two kernels, as on the TPU.  dq: a block of 4 warps owns 64 query rows
//   (16 a warp) and walks the key tiles; S = Q.K^T and dP = dO.V^T sit in
//   accumulator fragments, and dS goes straight from them into the A
//   operand of dQ += dS.K.  dk/dv: a block owns 64 key rows and walks the
//   query tiles (kv-block-outer); it computes S^T = K.Q^T and dP^T =
//   V.dO^T, so P^T and dS^T sit in the accumulators as the A operands of
//   dV += P^T.dO and dK += dS^T.Q.  Each output row is owned by one warp
//   and written once: no atomics, and the gradients are deterministic.
// * The block's own rows (Q and dO for dq; K and V for dk/dv) are staged
//   once; the streamed tiles (K and V; Q, dO, lse and Delta) come through
//   a two-stage cp.async ring, one barrier a tile.  16-byte copies where
//   every row of q, k, v and do is 16-byte aligned (decided per launch),
//   else one element a thread: the same kernel either way.
// * Head-width buckets of 32, 64, 96 and 128 lanes.  Streamed tiles: dq 64
//   key rows for D <= 64 and 32 above; dk/dv 32 query rows and 16 above,
//   which keeps the accumulators of D = 128 (dk/dv: two 16 x 128 a warp)
//   in registers.  Outputs that sum over the streamed rows take each
//   tile's products in a fresh accumulator (tc::gemm_pY_acc): the tensor
//   cores' accumulation does not round to nearest, and a chain over
//   thousands of rows drifts.
// * Causal and Tq != Tk: dq stops at its last row's diagonal (a row at
//   q_pos >= Tk sees every key), and its longest query tiles launch
//   first; dk/dv starts at the first query tile that sees its first key,
//   and a key block past every query writes zeros without loading
//   anything.
// Every entry point returns cudaGetLastError() after its launch.

#include "tensor_core.cuh"

namespace {

constexpr int kMaxHeadDim = 128;
constexpr int ROWS = 64;  // output rows a block owns, 16 a warp
constexpr int NT = 128;   // threads per block
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

using tc::gemm_abT;
using tc::Layout;
using tc::round_to;
using tc::rows16;
using tc::store_rows;

template <typename T, int DP>
struct Cfg {
  static constexpr int SW = tc::stride<T>(DP);
  static constexpr int BN = DP <= 64 ? 64 : 32;  // dq: key rows per tile
  static constexpr int BM = DP <= 64 ? 32 : 16;  // dk/dv: query rows per tile
  // dq: Q, dO, then STAGES x (K, V)
  static constexpr int DQ_SMEM =
      (2 * ROWS * SW + STAGES * 2 * BN * SW) * (int)sizeof(T);
  // dk/dv: K, V, then STAGES x (Q, dO, lse, Delta)
  static constexpr int STAGE_DKV = 2 * BM * SW * (int)sizeof(T) + 2 * BM * 4;
  static constexpr int DKV_SMEM =
      2 * ROWS * SW * (int)sizeof(T) + STAGES * STAGE_DKV;
  static_assert(STAGE_DKV % 16 == 0, "stages start 16-byte aligned");
};

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq,
                  Layout lq, Layout lk, Layout lv, Layout ldo, Layout ldq,
                  int H, int Tq, int Tk, int D, int causal, float scale,
                  int vec16) {
  using C = Cfg<T, DP>;
  constexpr int SW = C::SW, BN = C::BN;
  constexpr bool F32 = tc::kIsF32<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ds = Qs + ROWS * SW;  // dO
  T* KV = Ds + ROWS * SW;  // [STAGES][K, V][BN][SW]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nq = gridDim.z;
  // causal: the longest query tiles (the last) launch first
  const int qt = causal ? nq - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int q0 = qt * ROWS;
  const int warp = threadIdx.x >> 5;
  const int g = tc::lane_id() >> 2, t = tc::lane_id() & 3;
  const T* kb = k + b * lk.b + h * lk.h;
  const T* vb = v + b * lv.b + h * lv.h;
  const long long st0 = ((long long)b * H + h) * Tq;

  const int k_end = causal ? min(Tk, min(q0 + ROWS, Tq)) : Tk;
  const int nk = (k_end + BN - 1) / BN;

  // this thread's rows row0 and row0 + 8: lse (exp2 domain), Delta and
  // the causal limit (key j visible when j <= lim)
  const int row0 = q0 + warp * 16 + g;
  float l2[2], dl[2];
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool live = row < Tq;
    l2[r] = live ? lse[st0 + row] * LOG2E : 0.f;
    dl[r] = live ? delta[st0 + row] : 0.f;
    lim[r] = !live ? -1 : (causal ? min(row, Tk - 1) : Tk - 1);
  }

  float acc[DP / 8][4];
  tc::zero(acc);
  tc::stage<T, ROWS, DP, SW, NT>(Qs, q + b * lq.b + h * lq.h, lq.t, q0, Tq,
                                 D, vec16);
  tc::stage<T, ROWS, DP, SW, NT>(Ds, dout + b * ldo.b + h * ldo.h, ldo.t,
                                 q0, Tq, D, vec16);
  tc::stage<T, BN, DP, SW, NT>(KV, kb, lk.t, 0, k_end, D, vec16);
  tc::stage<T, BN, DP, SW, NT>(KV + BN * SW, vb, lv.t, 0, k_end, D, vec16);
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
    gemm_abT<BN / 8, DP>(s, Qs, warp * 16, Ks);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + j * 8 + 2 * t + (i & 1);
        s[j][i] = col <= lim[i >> 1] ? exp2f(s[j][i] * c1 - l2[i >> 1])
                                     : 0.f;
      }

    // dP = dO.V^T; dS = P * (dP - Delta), in k's dtype
    float dp[BN / 8][4];
    tc::zero(dp);
    gemm_abT<BN / 8, DP>(dp, Ds, warp * 16, Vs);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dp[j][i] = round_to(s[j][i] * (dp[j][i] - dl[i >> 1]), T());

    // dQ += dS.K
    tc::gemm_pY_acc<BN / 8, DP / 8, SW, !F32>(acc, dp, Ks);
  }

  store_rows<DP>(dq + b * ldq.b + h * ldq.h, ldq.t, acc, scale,
                 q0 + warp * 16, Tq, D);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
mha_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, Layout lq, Layout lk, Layout lv,
                   Layout ldo, Layout ldk, Layout ldv, int H, int Tq, int Tk,
                   int D, int causal, float scale, int vec16) {
  using C = Cfg<T, DP>;
  constexpr int SW = C::SW, BM = C::BM;
  constexpr bool F32 = tc::kIsF32<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + ROWS * SW;
  unsigned char* ring = reinterpret_cast<unsigned char*>(Vs + ROWS * SW);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * ROWS;  // causal: the first blocks work most
  const int warp = threadIdx.x >> 5;
  const int g = tc::lane_id() >> 2, t = tc::lane_id() & 3;
  const T* qb = q + b * lq.b + h * lq.h;
  const T* db = dout + b * ldo.b + h * ldo.h;
  const long long st0 = ((long long)b * H + h) * Tq;
  const float* lb = lse + st0;
  const float* deb = delta + st0;

  // causal: query tiles wholly before this block's first key see none of
  // its keys; a block past every query does not loop at all
  const int q_begin = causal ? min(Tq, (k0 / BM) * BM) : 0;
  const int nt = (Tq - q_begin + BM - 1) / BM;

  // this thread's keys key0 and key0 + 8: query i sees the key when
  // lim <= i < Tq (a key past Tk: never)
  const int key0 = k0 + warp * 16 + g;
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    lim[r] = key >= Tk ? Tq : (causal ? key : 0);
  }

  auto stage_q = [&](int s, int qs) {
    unsigned char* p = ring + s * C::STAGE_DKV;
    T* Qt = reinterpret_cast<T*>(p);
    T* Dt = Qt + BM * SW;
    float* Lt = reinterpret_cast<float*>(Dt + BM * SW);  // then Delta
    tc::stage<T, BM, DP, SW, NT>(Qt, qb, lq.t, qs, Tq, D, vec16);
    tc::stage<T, BM, DP, SW, NT>(Dt, db, ldo.t, qs, Tq, D, vec16);
    for (int i = threadIdx.x; i < 2 * BM; i += NT) {
      const int r = i % BM;
      const bool ok = qs + r < Tq;
      const float* src = i < BM ? lb : deb;
      tc::cp_async4(Lt + i, ok ? src + qs + r : src, ok ? 4 : 0);
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
    const T* Dt = Qt + BM * SW;
    const float* Lt = reinterpret_cast<const float*>(Dt + BM * SW);
    const float* Dl = Lt + BM;

    // S^T = K.Q^T, then P^T (fp32) under the masks
    float s[BM / 8][4];
    tc::zero(s);
    gemm_abT<BM / 8, DP>(s, Ks, warp * 16, Qt);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * t + e;  // query qs + c
        const float l2 = Lt[c] * LOG2E;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool ok = qs + c >= lim[r] && qs + c < Tq;
          float& x = s[j][2 * r + e];
          x = ok ? exp2f(x * c1 - l2) : 0.f;
        }
      }

    // dV += P^T.dO (bf16/fp16: p rounded to do's dtype first)
    tc::gemm_pY_acc<BM / 8, DP / 8, SW, !F32>(dva, s, Dt);

    // dP^T = V.dO^T; dS^T = P^T * (dP^T - Delta), in q's dtype
    float dp[BM / 8][4];
    tc::zero(dp);
    gemm_abT<BM / 8, DP>(dp, Vs, warp * 16, Dt);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dp[j][i] = round_to(s[j][i] * (dp[j][i] - Dl[j * 8 + 2 * t + (i & 1)]),
                            T());

    // dK += dS^T.Q
    tc::gemm_pY_acc<BM / 8, DP / 8, SW, !F32>(dka, dp, Qt);
  }

  store_rows<DP>(dk + b * ldk.b + h * ldk.h, ldk.t, dka, scale,
                 k0 + warp * 16, Tk, D);
  store_rows<DP>(dv + b * ldv.b + h * ldv.h, ldv.t, dva, 1.f,
                 k0 + warp * 16, Tk, D);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  Layout ls[6];  // q, k, v, do, then dq (dq kernel) or dk, dv (dk/dv kernel)
  int B, H, Tq, Tk, D, causal;
};

template <typename T, int DP>
cudaError_t launch_dp(int which, const Args& a, cudaStream_t stream) {
  using C = Cfg<T, DP>;
  const float scale = 1.f / sqrtf((float)a.D);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* d = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  // 16-byte staging when every staged row of q, k, v and do is aligned
  const int es = (int)sizeof(T);
  const int vec16 = rows16(q, a.ls[0], es) && rows16(k, a.ls[1], es) &&
                    rows16(v, a.ls[2], es) && rows16(d, a.ls[3], es);
  cudaError_t e;
  if (which == 0) {
    e = tc::allow_smem<&mha_bwd_dq_kernel<T, DP>>(C::DQ_SMEM);
    if (e != cudaSuccess) return e;
    const dim3 grid(a.H, a.B, (a.Tq + ROWS - 1) / ROWS);
    mha_bwd_dq_kernel<T, DP><<<grid, NT, C::DQ_SMEM, stream>>>(
        q, k, v, d, lse, delta, static_cast<T*>(a.dq), a.ls[0], a.ls[1],
        a.ls[2], a.ls[3], a.ls[4], a.H, a.Tq, a.Tk, a.D, a.causal, scale,
        vec16);
  } else {
    e = tc::allow_smem<&mha_bwd_dkv_kernel<T, DP>>(C::DKV_SMEM);
    if (e != cudaSuccess) return e;
    const dim3 grid(a.H, a.B, (a.Tk + ROWS - 1) / ROWS);
    mha_bwd_dkv_kernel<T, DP><<<grid, NT, C::DKV_SMEM, stream>>>(
        q, k, v, d, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        a.ls[0], a.ls[1], a.ls[2], a.ls[3], a.ls[4], a.ls[5], a.H, a.Tq,
        a.Tk, a.D, a.causal, scale, vec16);
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
      a.D > kMaxHeadDim || a.B > 65535 ||
      ((which == 0 ? a.Tq : a.Tk) + ROWS - 1) / ROWS > 65535)
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

// strides: 15 element strides, (batch, head, row) of q, k, v, do and dq.
// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, do and dq share
// it); lse and delta are float32 (B, H, Tq), contiguous.
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

// dynamic shared memory a block takes (which: 0 = dq, 1 = dk/dv; D the
// head width; dtype as above), for chip_smoke.py's resource report
extern "C" int flash_mha_bwd_smem_bytes(int which, int D, int dtype) {
  return dtype == 0   ? smem_of<float>(which, D)
         : dtype == 1 ? smem_of<__nv_bfloat16>(which, D)
                      : smem_of<__half>(which, D);
}
