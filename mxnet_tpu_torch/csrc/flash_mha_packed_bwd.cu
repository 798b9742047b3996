// Packed-QKV flash attention, backward, for Hopper (sm_90a), on the tensor
// cores.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:_mhap_bwd (its two Pallas
// kernels _mhap_bwd_dq_kernel and _mhap_bwd_dkv_kernel, the backward of
// flash_mha_packed).  Same function: from the packed qkv (B, T, 3*H*D), the
// forward's output o and row log-sum-exp lse (B, T, H, natural log), and
// the output cotangent do, rebuild p = exp2(s*log2(e) - lse*log2(e)) with
// s = q.k^T*scale, blockwise, and form
//   Delta = rowsum(do * o),   ds = p * (do.v^T - Delta),
//   dq = ds.k*scale,  dk = ds^T.q*scale,  dv = p^T.do,
// written PACKED into one dqkv (B, T, 3*H*D) buffer: dq into the first third,
// dk and dv into the other two (no concatenate).
//
// Rounding, as the TPU kernels': every product accumulates in fp32.  fp32:
// all five products (q.k^T, do.v^T, ds.k, ds^T.q, p^T.do) as split TF32,
// three tensor-core products each (tensor_core.cuh).  bf16 and fp16: all
// five on the type's tensor cores, ds rounded to it before ds.k and ds^T.q
// (ds.astype(
// k.dtype)) and p before p^T.do (pT = p.astype(do.dtype)).
//
// What bounds it on the H100: the work.  At B=8, T=1024, H=12, D=64, causal,
// the two kernels do ~4.5e10 FLOP against ~200 MB of traffic (fp32), far
// above the memory line.  Split TF32 runs three TF32 products for each fp32
// one: 165 TFLOP/s in effect; bf16 and fp16 up to 989.
//
// Design (B9's, flash_attention_partial_bwd.cu, on the packed layout):
// * Two kernels, as on the TPU.  Each output row is owned by one warp and
//   written once: no atomics, deterministic gradients.  dq: a block of 4
//   warps owns 64 query rows (16 a warp) and walks key tiles; S = Q.K^T
//   and dP = dO.V^T sit in accumulator fragments, and dS goes straight from
//   them into the A operand of dQ += dS.K.  dk/dv: a block owns 64 key rows
//   and walks query tiles (kv-block-outer); it computes S^T = K.Q^T
//   and dP^T = V.dO^T, so P^T and dS^T sit in the accumulators as the A
//   operands of dV += P^T.dO and dK += dS^T.Q.
// * Delta stays in-kernel, as on the TPU: the dq kernel takes it once for
//   its own rows from the staged o and do tiles (o passes through the
//   ring's second stage); the dk/dv kernel takes it for every streamed
//   query tile from the o and do tiles the ring carries beside q (three
//   tiles and lse a stage): four lanes share a row, a quarter each, 8 rows
//   a warp (tc::row_dot, conflict-free 16-byte shared loads), into the
//   stage's Delta vector, which a second barrier publishes before dS
//   needs it.
//   (One lane a row in every warp would read the tile's 32 rows four
//   times over, through shared memory, which this kernel runs short of
//   before the tensor cores.)
// * The block's own rows (Q, dO for dq; K, V for dk/dv) are staged once;
//   the streamed tiles come through a two-stage cp.async ring, one barrier
//   a tile.  16-byte copies where qkv, o and do start 16-byte aligned and
//   D is a multiple of 16 bytes (every row is then), else one element a
//   thread: the same kernel either way.  Rows are 3*H*D elements apart in qkv and dqkv, H*D in o
//   and do; lse is (B, T, H), H apart.
// * Outputs that sum over the streamed rows take each tile's products in a
//   fresh accumulator added on the CUDA cores (tc::gemm_pY_acc).
// * Causal: dq stops at its last row's diagonal and its longest q-tiles
//   launch first; dk/dv starts at the first query tile that sees its first
//   key.
// * Head-width buckets of 32, 64, 96 and 128 lanes, as B5's backward
//   (flash_mha_bwd.cu); lanes past D stage as zero and are never stored.
//   Streamed tiles: dq 64 key rows for D <= 64 and 32 above; dk/dv 32
//   query rows and 16 above (its Delta then takes two warps), which keeps
//   the accumulators of D = 128 (dk/dv: two 16 x 128 a warp) in
//   registers.
// Every entry point returns cudaGetLastError() after its launch.

#include "tensor_core.cuh"

namespace {

constexpr int kMaxHeadDim = 128;
constexpr int ROWS = 64;    // output rows a block owns, 16 a warp
constexpr int NT = 128;     // threads per block
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

using tc::gemm_abT;
using tc::round_to;
using tc::store_rows;

template <typename T, int DP>
struct Cfg {
  static constexpr int SW = tc::stride<T>(DP);
  static constexpr int BN = DP <= 64 ? 64 : 32;  // dq: key rows per tile
  static constexpr int BM = DP <= 64 ? 32 : 16;  // dk/dv: query rows per tile
  // dq: Q, dO, then STAGES x (K, V); o passes through stage 1
  static constexpr int DQ_SMEM =
      (2 * ROWS * SW + STAGES * 2 * BN * SW) * (int)sizeof(T);
  // dk/dv: K, V, then STAGES x (Q, dO, o, lse, Delta)
  static constexpr int STAGE_DKV = 3 * BM * SW * (int)sizeof(T) + 2 * BM * 4;
  static constexpr int DKV_SMEM =
      2 * ROWS * SW * (int)sizeof(T) + STAGES * STAGE_DKV;
  static_assert(STAGE_DKV % 16 == 0, "stages start 16-byte aligned");
  static_assert(ROWS <= 2 * BN, "o fits in one stage");
  static_assert(BM % 8 == 0 && BM <= 32, "8 rows a warp for Delta");
};

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
mhap_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ o,
                   const float* __restrict__ lse, const T* __restrict__ dout,
                   T* __restrict__ dqkv, int T_, int H, int D, int causal,
                   float scale, int vec16) {
  using C = Cfg<T, DP>;
  constexpr int SW = C::SW, BN = C::BN;
  constexpr int TILE = BN * SW;
  constexpr bool F32 = tc::kIsF32<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ds = Qs + ROWS * SW;  // dO
  T* KV = Ds + ROWS * SW;  // [STAGES][K, V][BN][SW]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nq = gridDim.z;
  const int qt = causal ? nq - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int q0 = qt * ROWS;
  const int warp = threadIdx.x >> 5;
  const int lane = tc::lane_id();
  const int g = lane >> 2, t = lane & 3;
  const int HD = H * D;
  const long long rs = 3LL * HD;  // elements between tokens of qkv, dqkv
  const T* qb = qkv + (long long)b * T_ * rs + h * D;
  const T* kb = qb + HD;
  const T* vb = qb + 2 * HD;
  const T* ob = o + (long long)b * T_ * HD + h * D;
  const T* dob = dout + (long long)b * T_ * HD + h * D;

  const int q_last = min(T_, q0 + ROWS) - 1;
  const int k_end = causal ? q_last + 1 : T_;
  const int nk = (k_end + BN - 1) / BN;

  T* Os = KV + 2 * TILE;  // stage 1, free until the loop refills it
  tc::stage<T, ROWS, DP, SW, NT>(Qs, qb, rs, q0, T_, D, vec16);
  tc::stage<T, ROWS, DP, SW, NT>(Ds, dob, HD, q0, T_, D, vec16);
  tc::stage<T, ROWS, DP, SW, NT>(Os, ob, HD, q0, T_, D, vec16);
  tc::stage<T, BN, DP, SW, NT>(KV, kb, rs, 0, k_end, D, vec16);
  tc::stage<T, BN, DP, SW, NT>(KV + TILE, vb, rs, 0, k_end, D, vec16);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  // Delta of the warp's 16 rows, one a lane (lanes 16.. repeat them), then
  // this thread's rows row0 and row0 + 8: Delta, lse (exp2 domain) and the
  // causal limit (key j visible when j <= lim)
  const int mine = warp * 16 + (lane & 15);
  const float dmine = tc::row_dot<DP>(Ds + mine * SW, Os + mine * SW);
  const int row0 = q0 + warp * 16 + g;
  float dl[2], l2[2];
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    dl[r] = __shfl_sync(0xffffffffu, dmine, g + 8 * r);
    l2[r] = row < T_ ? lse[((long long)b * T_ + row) * H + h] * LOG2E : 0.f;
    lim[r] = causal ? min(row, T_ - 1) : T_ - 1;
  }
  const float c1 = scale * LOG2E;

  float acc[DP / 8][4];
  tc::zero(acc);
  for (int it = 0; it < nk; ++it) {
    // one barrier a tile: tile it has landed for every thread, and every
    // thread is done with the stage the next copy refills (tile it - 1's,
    // or the o tile's before the first)
    tc::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < nk) {
      T* nxt = KV + ((it + 1) % STAGES) * 2 * TILE;
      tc::stage<T, BN, DP, SW, NT>(nxt, kb, rs, (it + 1) * BN, k_end, D,
                                   vec16);
      tc::stage<T, BN, DP, SW, NT>(nxt + TILE, vb, rs, (it + 1) * BN, k_end,
                                   D, vec16);
    }
    tc::cp_async_commit();
    const T* Ks = KV + (it % STAGES) * 2 * TILE;
    const T* Vs = Ks + TILE;
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

    // dP = dO.V^T; dS = P * (dP - Delta), in the inputs' dtype
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

  store_rows<DP>(dqkv + (long long)b * T_ * rs + h * D, rs, acc, scale,
                 q0 + warp * 16, T_, D);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
mhap_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ o,
                    const float* __restrict__ lse,
                    const T* __restrict__ dout, T* __restrict__ dqkv, int T_,
                    int H, int D, int causal, float scale, int vec16) {
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
  const int lane = tc::lane_id();
  const int g = lane >> 2, t = lane & 3;
  const int HD = H * D;
  const long long rs = 3LL * HD;
  const T* qb = qkv + (long long)b * T_ * rs + h * D;
  const T* ob = o + (long long)b * T_ * HD + h * D;
  const T* dob = dout + (long long)b * T_ * HD + h * D;
  const float* lb = lse + (long long)b * T_ * H + h;

  // causal: query tiles wholly before this block's first key see none of
  // its keys
  const int q_begin = causal ? (k0 / BM) * BM : 0;
  const int nt = (T_ - q_begin + BM - 1) / BM;

  // this thread's keys key0 and key0 + 8: query i sees the key when
  // lim <= i < T (a key past T: never)
  const int key0 = k0 + warp * 16 + g;
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    lim[r] = key >= T_ ? T_ : (causal ? key : 0);
  }

  auto stage_q = [&](int s, int qs) {
    unsigned char* p = ring + s * C::STAGE_DKV;
    T* Qt = reinterpret_cast<T*>(p);
    T* Dt = Qt + BM * SW;
    T* Ot = Dt + BM * SW;
    float* Lt = reinterpret_cast<float*>(Ot + BM * SW);  // then Delta
    tc::stage<T, BM, DP, SW, NT>(Qt, qb, rs, qs, T_, D, vec16);
    tc::stage<T, BM, DP, SW, NT>(Dt, dob, HD, qs, T_, D, vec16);
    tc::stage<T, BM, DP, SW, NT>(Ot, ob, HD, qs, T_, D, vec16);
    for (int i = threadIdx.x; i < BM; i += NT) {
      const bool ok = qs + i < T_;
      tc::cp_async4(Lt + i, ok ? lb + (long long)(qs + i) * H : lb,
                    ok ? 4 : 0);
    }
  };

  float dka[DP / 8][4], dva[DP / 8][4];
  tc::zero(dka);
  tc::zero(dva);
  tc::stage<T, ROWS, DP, SW, NT>(Ks, qb + HD, rs, k0, T_, D, vec16);
  tc::stage<T, ROWS, DP, SW, NT>(Vs, qb + 2 * HD, rs, k0, T_, D, vec16);
  stage_q(0, q_begin);
  tc::cp_async_commit();
  const float c1 = scale * LOG2E;

  for (int it = 0; it < nt; ++it) {
    const int qs = q_begin + it * BM;
    tc::cp_async_wait<0>();  // the first barrier a tile, as in dq's
    __syncthreads();
    if (it + 1 < nt) stage_q((it + 1) % STAGES, qs + BM);
    tc::cp_async_commit();
    unsigned char* p = ring + (it % STAGES) * C::STAGE_DKV;
    const T* Qt = reinterpret_cast<const T*>(p);
    const T* Dt = Qt + BM * SW;
    const T* Ot = Dt + BM * SW;
    float* Lt = reinterpret_cast<float*>(p + 3 * BM * SW * sizeof(T));
    float* Dl = Lt + BM;

    // Delta of the tile's rows: warp w rows 8w..8w+7 (the first BM / 8
    // warps), lanes i, i+8, i+16 and i+24 a quarter each of row 8w + i%8
    // (for a fixed quarter the 8 rows' 16-byte loads fall in distinct
    // banks)
    if (warp < BM / 8) {
      const int r = warp * 8 + (lane & 7), part = (lane >> 3) * (DP / 4);
      float d = tc::row_dot<DP / 4>(Dt + r * SW + part, Ot + r * SW + part);
      d += __shfl_xor_sync(0xffffffffu, d, 8);
      d += __shfl_xor_sync(0xffffffffu, d, 16);
      if (lane < 8) Dl[r] = d;
    }
    // lse of this thread's columns (queries qs + j*8 + 2t + e), exp2 domain
    float l2[BM / 8][2];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) l2[j][e] = Lt[j * 8 + 2 * t + e] * LOG2E;

    // S^T = K.Q^T, then P^T (fp32) under the masks
    float s[BM / 8][4];
    tc::zero(s);
    gemm_abT<BM / 8, DP>(s, Ks, warp * 16, Qt);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = qs + j * 8 + 2 * t + (i & 1);
        const bool ok = qc >= lim[i >> 1] && qc < T_;
        s[j][i] = ok ? exp2f(s[j][i] * c1 - l2[j][i & 1]) : 0.f;
      }

    // dV += P^T.dO (bf16/fp16: p rounded to the input type first)
    tc::gemm_pY_acc<BM / 8, DP / 8, SW, !F32>(dva, s, Dt);

    // dP^T = V.dO^T; dS^T = P^T * (dP^T - Delta), in the inputs' dtype
    float dp[BM / 8][4];
    tc::zero(dp);
    gemm_abT<BM / 8, DP>(dp, Vs, warp * 16, Dt);
    __syncthreads();  // every warp's part of Delta has landed
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dp[j][i] = round_to(
            s[j][i] * (dp[j][i] - Dl[j * 8 + 2 * t + (i & 1)]), T());

    // dK += dS^T.Q
    tc::gemm_pY_acc<BM / 8, DP / 8, SW, !F32>(dka, dp, Qt);
  }

  T* out = dqkv + (long long)b * T_ * rs + h * D;
  store_rows<DP>(out + HD, rs, dka, scale, k0 + warp * 16, T_, D);
  store_rows<DP>(out + 2 * HD, rs, dva, 1.f, k0 + warp * 16, T_, D);
}

struct Args {
  const void *qkv, *o, *lse, *dout;
  void* dqkv;
  int B, T, H, D, causal;
};

template <typename T, int DP>
cudaError_t launch_dp(int which, const Args& a, cudaStream_t stream) {
  using C = Cfg<T, DP>;
  const float scale = 1.f / sqrtf((float)a.D);
  const T* in = static_cast<const T*>(a.qkv);
  const T* oo = static_cast<const T*>(a.o);
  const float* l = static_cast<const float*>(a.lse);
  const T* d = static_cast<const T*>(a.dout);
  T* out = static_cast<T*>(a.dqkv);
  // rows of qkv (3*H*D apart), o and do (H*D apart) and heads (D apart)
  // start 16-byte aligned when the bases do and D is a multiple of 16
  // bytes
  auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec16 = al(a.qkv) && al(a.o) && al(a.dout) &&
                    (a.D * (int)sizeof(T)) % 16 == 0;
  const dim3 grid(a.H, a.B, (a.T + ROWS - 1) / ROWS);
  cudaError_t e;
  if (which == 0) {
    e = tc::allow_smem<&mhap_bwd_dq_kernel<T, DP>>(C::DQ_SMEM);
    if (e != cudaSuccess) return e;
    mhap_bwd_dq_kernel<T, DP><<<grid, NT, C::DQ_SMEM, stream>>>(
        in, oo, l, d, out, a.T, a.H, a.D, a.causal, scale, vec16);
  } else {
    e = tc::allow_smem<&mhap_bwd_dkv_kernel<T, DP>>(C::DKV_SMEM);
    if (e != cudaSuccess) return e;
    mhap_bwd_dkv_kernel<T, DP><<<grid, NT, C::DKV_SMEM, stream>>>(
        in, oo, l, d, out, a.T, a.H, a.D, a.causal, scale, vec16);
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

int dispatch(int which, const Args& a, int dtype, void* stream) {
  if (a.B < 1 || a.T < 1 || a.H < 1 || a.D < 1 || a.D > kMaxHeadDim ||
      a.B > 65535 || (a.T + ROWS - 1) / ROWS > 65535)
    return (int)cudaErrorInvalidValue;
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

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (qkv, o, dout and dqkv
// share it; lse is float32 (B, T, H), natural log).  dq writes dqkv's first third.
extern "C" int flash_mha_packed_bwd_dq(const void* qkv, const void* o,
                                       const void* lse, const void* dout,
                                       void* dqkv, int B, int T, int H, int D,
                                       int causal, int dtype, void* stream) {
  return dispatch(0, Args{qkv, o, lse, dout, dqkv, B, T, H, D, causal},
                  dtype, stream);
}

// dk and dv write dqkv's second and third thirds.
extern "C" int flash_mha_packed_bwd_dkv(const void* qkv, const void* o,
                                        const void* lse, const void* dout,
                                        void* dqkv, int B, int T, int H,
                                        int D, int causal, int dtype,
                                        void* stream) {
  return dispatch(1, Args{qkv, o, lse, dout, dqkv, B, T, H, D, causal},
                  dtype, stream);
}

// dynamic shared memory a block takes (which: 0 = dq, 1 = dk/dv; D the
// head width; dtype as above), for chip_smoke.py's resource report
extern "C" int flash_mha_packed_bwd_smem_bytes(int which, int D, int dtype) {
  return dtype == 0   ? smem_of<float>(which, D)
         : dtype == 1 ? smem_of<__nv_bfloat16>(which, D)
                      : smem_of<__half>(which, D);
}
