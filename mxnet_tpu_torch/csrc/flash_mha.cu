// Normalized multi-head flash attention, forward, for Hopper (sm_90a), on
// the tensor cores.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:_mha_fwd (the Pallas kernel
// _mha_fwd_kernel behind flash_mha, the attention of DotProductAttention).
// Same function: q (B, H, Tq, D), k and v (B, H, Tk, D), three separate
// tensors of any head width D up to kMaxHeadDim, Tq and Tk free (tails
// included), causal mask k_pos <= q_pos aligned at position 0 (a row with
// q_pos >= Tk sees every key) →
//   o (B, H, Tq, D) in q's dtype, normalized in-kernel, and
//   lse (B, H, Tq) float32, natural log: m + log(max(l, 1e-30)).
//
// Rounding, as the TPU kernel's: scores s = (q.k^T) * scale*log2(e) in the
// exp2 domain, accumulated in fp32.  fp32: Q.K^T and P.V each as split
// TF32 (three tensor-core products, tensor_core.cuh), which keeps fp32's
// accuracy.  bf16: Q.K^T on bf16 tensor cores; P is rounded to bf16 before
// P.V (p.astype(v.dtype)), which then runs on bf16 tensor cores; the row
// sum l is taken over fp32 p.
//
// Layout: every tensor is addressed through its own (batch, head, row)
// element strides, lanes contiguous.  blockwise_attention hands the kernel
// BTHD and BHTD views alike, with no transpose copy; o is written through
// its own strides (the wrapper gives it q's layout).  lse is contiguous.
//
// What bounds it on the H100: the work.  Causal attention at B=8, H=12,
// T=1024, D=64 is ~12.9 GFLOP against ~100 MB (fp32), far above the
// memory line.  Split TF32 runs three TF32 products for each fp32 one:
// 495 / 3 = 165 TFLOP/s in effect; bf16 runs at up to 989 TFLOP/s.
//
// Design (B1's forward, flash_mha_packed.cu, over strided tensors and any
// D; why mma.sync and not wgmma: there):
// * A block of 4 warps owns 64 query rows of one (batch, head); a warp owns
//   16.  S, the online-softmax state (m, l) and the output accumulator
//   live in accumulator fragments; each tile's P.V is summed in a fresh
//   accumulator and added to the output's on the CUDA cores
//   (tc::gemm_pY_acc).  The loop over key tiles inside the block takes the
//   place of the TPU grid's sequential kj axis.
// * Templated on the head-width bucket DP (32, 64, 96, 128; lanes past D
//   stage as zero).  Up to DP = 64 the warp's Q fragments (split into big
//   and small in fp32) stay in registers, Q passing through the ring's
//   second stage, and key tiles hold 64 rows; above, Q keeps its own
//   shared tile and key tiles hold 32 rows, which keeps the 16 x 128
//   output accumulator in registers.
// * K and V tiles stream through a two-stage cp.async ring, one barrier a
//   tile.  16-byte copies where every row of q, k and v is 16-byte aligned
//   (the C entry decides per launch), else one element a thread: the same
//   kernel either way.
// * Masks (causal, the Tk tail) are applied on the fragments, on the tiles
//   that need them; causal blocks stop at min(Tk, the block's last row + 1)
//   and the longest q-tiles launch first.
// Every entry point returns cudaGetLastError() after its launch.

#include "tensor_core.cuh"

namespace {

constexpr int kMaxHeadDim = 128;
constexpr int BQ = 64;      // query rows per block, 16 per warp
constexpr int NT = 128;     // threads per block
constexpr int STAGES = 2;   // K/V tiles in flight
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

using tc::Layout;
using tc::rows16;

template <typename T, int DP>
struct Cfg {
  static constexpr int SW = tc::stride<T>(DP);
  static constexpr bool QREG = DP <= 64;     // Q fragments in registers
  static constexpr int BN = QREG ? 64 : 32;  // key rows per tile
  static constexpr int TILE = BN * SW;
  // [Q (DP > 64)] then STAGES x (K, V); up to 64 Q goes through stage 1
  static constexpr int SMEM =
      ((QREG ? 0 : BQ * SW) + STAGES * 2 * TILE) * (int)sizeof(T);
  static_assert(!QREG || BQ <= 2 * BN, "Q fits in one stage");
};

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, Layout lq, Layout lk, Layout lv,
               Layout lo, int H, int Tq, int Tk, int D, int causal,
               float scale_log2, int vec16) {
  using C = Cfg<T, DP>;
  constexpr int SW = C::SW, BN = C::BN, TILE = C::TILE;
  constexpr bool F32 = tc::kIsF32<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);       // DP > 64: Q's own tile
  T* KV = Qs + (C::QREG ? 0 : BQ * SW);          // [STAGES][K, V][BN][SW]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nq = gridDim.z;
  const int qt = causal ? nq - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5;
  const int g = tc::lane_id() >> 2, t = tc::lane_id() & 3;
  const T* qb = q + b * lq.b + h * lq.h;
  const T* kb = k + b * lk.b + h * lk.h;
  const T* vb = v + b * lv.b + h * lv.h;

  // causal: the block's last row sees keys up to itself (rows at or past
  // Tk see every key)
  const int k_end = causal ? min(Tk, min(Tq, q0 + BQ)) : Tk;
  const int nk = (k_end + BN - 1) / BN;

  T* Qtile = C::QREG ? KV + 2 * TILE : Qs;
  tc::stage<T, BQ, DP, SW, NT>(Qtile, qb, lq.t, q0, Tq, D, vec16);
  tc::stage<T, BN, DP, SW, NT>(KV, kb, lk.t, 0, k_end, D, vec16);
  tc::stage<T, BN, DP, SW, NT>(KV + TILE, vb, lv.t, 0, k_end, D, vec16);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  constexpr int QK = C::QREG ? (F32 ? DP / 8 : DP / 16) : 1;  // k-steps
  uint32_t qa[QK][4], qs[F32 ? QK : 1][4];
  if constexpr (C::QREG) {
#pragma unroll
    for (int ks = 0; ks < QK; ++ks) {
      if constexpr (F32) {
        float a[4];
        tc::frag_a<SW>(a, Qtile, warp * 16, ks * 8);
        tc::split(a, qa[ks], qs[ks]);
      } else {
        tc::frag_a_bf16<SW>(qa[ks], Qtile, warp * 16, ks * 16);
      }
    }
  }

  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  float acc[DP / 8][4];
  tc::zero(acc);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's part of each row's sum

  for (int it = 0; it < nk; ++it) {
    // one barrier a tile: tile it has landed for every thread, and every
    // thread is done with the stage the next copy refills (tile it - 1's,
    // or, up to DP = 64, the Q tile's before the first)
    tc::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < nk) {
      T* nxt = KV + ((it + 1) % STAGES) * 2 * TILE;
      tc::stage<T, BN, DP, SW, NT>(nxt, kb, lk.t, (it + 1) * BN, k_end, D,
                                   vec16);
      tc::stage<T, BN, DP, SW, NT>(nxt + TILE, vb, lv.t, (it + 1) * BN,
                                   k_end, D, vec16);
    }
    tc::cp_async_commit();
    const T* Ks = KV + (it % STAGES) * 2 * TILE;
    const T* Vs = Ks + TILE;
    const int k0 = it * BN;

    // S = Q.K^T (16 x BN per warp)
    float s[BN / 8][4];
    tc::zero(s);
    if constexpr (C::QREG) {
#pragma unroll
      for (int ks = 0; ks < QK; ++ks) {
        if constexpr (F32) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            float bf[2];
            uint32_t bb[2], bs[2];
            tc::frag_b<SW>(bf, Ks, j * 8, ks * 8);
            tc::split(bf, bb, bs);
            tc::mma3(s[j], qa[ks], qs[ks], bb, bs);
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < BN / 16; ++jj) {
            uint32_t r[4];
            tc::frag_b_bf16<SW>(r, Ks, jj * 16, ks * 16);
            const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
            tc::mma_bf16(s[2 * jj], qa[ks], b0);
            tc::mma_bf16(s[2 * jj + 1], qa[ks], b1);
          }
        }
      }
    } else if constexpr (F32) {
      tc::gemm_abT_tf32<BN / 8, DP, SW, SW, false, false>(s, Qs, warp * 16,
                                                          Ks);
    } else {
      tc::gemm_abT_bf16<BN / 8, DP, SW>(s, Qs, warp * 16, Ks);
    }

    // online softmax on the fragments, exp2 domain
    const bool masked = k0 + BN > Tk || (causal && k0 + BN - 1 > q0);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[j][i] * scale_log2;
        if (masked) {
          const int col = k0 + j * 8 + 2 * t + (i & 1);
          const int row = row0 + (i >> 1) * 8;
          if (col >= Tk || (causal && col > row)) x = -INFINITY;
        }
        s[j][i] = x;
        mt[i >> 1] = fmaxf(mt[i >> 1], x);
      }
    float msafe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], tc::quad_max(mt[r]));
      msafe[r] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - msafe[r]);  // 0 while m is -inf
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(s[j][i] - msafe[i >> 1]);  // masked: 0
        s[j][i] = p;
        l[i >> 1] += p;
      }

    // acc += P.V, summed a tile at a time (tc::gemm_pY_acc); bf16 rounds p
    tc::gemm_pY_acc<BN / 8, DP / 8, SW, !F32>(acc, s, Vs);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const float lsafe = fmaxf(tc::quad_sum(l[r]), 1e-30f);
    if (row >= Tq) continue;
    const float inv = 1.f / lsafe;
    T* orow = o + b * lo.b + h * lo.h + row * lo.t;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < D) tc::store(orow + c, acc[n][2 * r] * inv);
      if (c + 1 < D) tc::store(orow + c + 1, acc[n][2 * r + 1] * inv);
    }
    if (t == 0)
      lse[((long long)b * H + h) * Tq + row] = (m[r] + log2f(lsafe)) * LN2;
  }
}

template <typename T, int DP>
cudaError_t launch_dp(const void* q, const void* k, const void* v, void* o,
                      void* lse, const Layout* ls, int B, int H, int Tq,
                      int Tk, int D, int causal, cudaStream_t stream) {
  constexpr int bytes = Cfg<T, DP>::SMEM;
  cudaError_t e = tc::allow_smem<&mha_fwd_kernel<T, DP>>(bytes);
  if (e != cudaSuccess) return e;
  const int es = (int)sizeof(T);
  const int vec16 = rows16(q, ls[0], es) && rows16(k, ls[1], es) &&
                    rows16(v, ls[2], es);
  const dim3 grid(H, B, (Tq + BQ - 1) / BQ);
  const float scale_log2 = LOG2E / sqrtf((float)D);
  mha_fwd_kernel<T, DP><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), ls[0], ls[1], ls[2], ls[3], H, Tq, Tk, D,
      causal, scale_log2, vec16);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, const Layout* ls, int B, int H, int Tq, int Tk,
                   int D, int causal, cudaStream_t s) {
  if (D <= 32)
    return launch_dp<T, 32>(q, k, v, o, lse, ls, B, H, Tq, Tk, D, causal, s);
  if (D <= 64)
    return launch_dp<T, 64>(q, k, v, o, lse, ls, B, H, Tq, Tk, D, causal, s);
  if (D <= 96)
    return launch_dp<T, 96>(q, k, v, o, lse, ls, B, H, Tq, Tk, D, causal, s);
  return launch_dp<T, 128>(q, k, v, o, lse, ls, B, H, Tq, Tk, D, causal, s);
}

template <typename T>
int smem_of(int D) {
  if (D <= 32) return Cfg<T, 32>::SMEM;
  if (D <= 64) return Cfg<T, 64>::SMEM;
  if (D <= 96) return Cfg<T, 96>::SMEM;
  return Cfg<T, 128>::SMEM;
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
      B > 65535 || (Tq + BQ - 1) / BQ > 65535)
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

// dynamic shared memory a block of the kernel takes at head width D, for
// chip_smoke.py's resource report (dtype as above)
extern "C" int flash_mha_smem_bytes(int D, int dtype) {
  return dtype == 0 ? smem_of<float>(D) : smem_of<__nv_bfloat16>(D);
}
