// The flash-attention forward body for Hopper (sm_90a), on the tensor
// cores, shared by flash_mha_packed.cu (B1: the packed qkv, normalized),
// flash_mha.cu (B5: separate q, k, v, normalized) and
// flash_attention_partial.cu (B8: the un-normalized state at a key
// offset).  The three TPU kernels compute one function and differ in their
// strides, their mask's offset and what they write; so do these.
//
// Function: q (B, H, Tq, D), k and v (B, H, Tk, D), each through its own
// (batch, head, row) element strides, lanes contiguous, any head width D
// up to kMaxHeadDim, Tq and Tk free (tails masked, never padded).  Row i
// sees key j when j <= lim_i = min(i - koff, Tk - 1) under the causal mask
// (koff = position of k[0] - position of q[0], 64-bit arithmetic: any
// int), and every key otherwise; with a per-row key limit kv_len (B,)
// int32 in device memory, row b's queries see no key j >= kv_len[b] on top
// of that (B8's suffix prefill and contiguous-cache decode; null: none).
// The epilogue (an Out policy) gets each
// row's un-normalized o = sum_j p_ij v_j, its max m in the exp2 domain and
// l = sum_j p_ij, with p_ij = exp2(s_ij - m_i); a row that sees no key
// holds m = -inf, l = 0, o = 0 exactly.
//
// Rounding, as the TPU kernels': scores s = (q.k^T) * scale*log2(e) in the
// exp2 domain, accumulated in fp32.  fp32: Q.K^T and P.V each as split
// TF32 (three tensor-core products, tensor_core.cuh), which keeps fp32's
// accuracy.  bf16 and fp16: Q.K^T on the type's tensor cores; P is rounded
// to the input type before P.V (p.astype(v.dtype)), which then runs on
// those tensor cores; the row sum l is taken over fp32 p.
//
// What bounds it on the H100: the work.  Causal attention at B=8, H=12,
// T=1024, D=64 is ~12.9 GFLOP against ~100 MB (fp32); a ring hop at (1,
// 12, 4096, 4096, 64) with nothing masked ~5.2e10 FLOP against ~38 MB: far
// above the memory line.  Split TF32 runs three TF32 products for each
// fp32 one: 495 / 3 = 165 TFLOP/s in effect; bf16 and fp16 run at up to
// 989.
//
// Design:
// * mma.sync (m16n8k8 TF32, m16n8k16 bf16 or fp16), not wgmma: wgmma reads a TF32
//   operand from shared memory only K-major, and V in P.V is MN-major, so
//   fp32 would need V staged transposed by threads; mma.sync takes every
//   operand from registers, loaded from padded shared tiles without bank
//   conflicts, and keeps P in registers between the two products (as
//   PyTorch's memory-efficient SDPA runs fp32).
// * A block of 4 warps owns 64 query rows of one (batch, head); a warp owns
//   16.  S, the online-softmax state (m, l) and the output accumulator
//   live in accumulator fragments; each tile's P.V is summed in a fresh
//   accumulator and added to the output's on the CUDA cores
//   (tc::gemm_pY_acc: the tensor cores' accumulation does not round to
//   nearest).  The loop over key tiles inside the block takes the place of
//   the TPU grid's sequential axis.
// * Templated on the head-width bucket DP (32, 64, 96, 128; lanes past D
//   stage as zero and are never stored).  Up to DP = 64 the warp's Q
//   fragments (split into big and small in fp32) stay in registers, Q
//   passing through the ring's second stage, and key tiles hold 64 rows;
//   above, Q keeps its own shared tile and key tiles hold 32 rows, which
//   keeps the 16 x 128 output accumulator in registers.
// * K and V tiles stream through a two-stage cp.async ring, one barrier a
//   tile.  16-byte copies where every row of q, k and v is 16-byte aligned
//   (decided per launch), else one element a thread: the same kernel
//   either way.
// * Masks are applied on the fragments, one compare against the row's
//   limit (which covers the Tk tail too), on the tiles that reach past the
//   block's first row's limit.  A block loads key tiles up to its last
//   valid row's limit; one that sees no key loads nothing and writes the
//   empty state.  The kernels launch the longest q-tiles (the last, under
//   the causal mask) first.

#pragma once

#include "tensor_core.cuh"

namespace fwd {

constexpr int kMaxHeadDim = 128;
constexpr int BQ = 64;      // query rows per block, 16 per warp
constexpr int NT = 128;     // threads per block
constexpr int STAGES = 2;   // K/V tiles in flight
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

using tc::Layout;

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

template <typename T>
int smem_of(int D) {
  if (D <= 32) return Cfg<T, 32>::SMEM;
  if (D <= 64) return Cfg<T, 64>::SMEM;
  if (D <= 96) return Cfg<T, 96>::SMEM;
  return Cfg<T, 128>::SMEM;
}

// the problem every forward hands the body; kv_len (B,) int32 on the
// device, or null (B1 and B5 leave it null)
struct Args {
  const void *q, *k, *v;
  Layout lq, lk, lv;
  int B, H, Tq, Tk, D, causal, koff;
  const int* kv_len;
};

// the last key row i sees (-1: none)
__device__ __forceinline__ int key_limit(int row, int koff, int Tk,
                                         int causal) {
  if (!causal) return Tk - 1;
  const long long lim = (long long)row - koff;
  return (int)max(-1LL, min((long long)Tk - 1, lim));
}

// Out policies: write(b, h, row, r, acc, m, l, D) gets a thread's part of
// row `row` (fragment rows r = 0, 1: g and g + 8), m in the exp2 domain and
// the row's full l; lane t == 0 of the quad writes the row's scalars.

// normalized o in T through its strides, lse = m + log(max(l, 1e-30)) in
// natural-log units through its own (B1, B5)
template <typename T>
struct Normalized {
  T* o;
  float* lse;
  Layout lo, ll;
  template <int DP>
  __device__ __forceinline__ void write(int b, int h, int row, int r,
                                        const float (&acc)[DP / 8][4],
                                        float m, float l, int D) const {
    const int t = tc::lane_id() & 3;
    const float lsafe = fmaxf(l, 1e-30f);
    const float inv = 1.f / lsafe;
    T* orow = o + b * lo.b + h * lo.h + row * lo.t;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < D) tc::store(orow + c, acc[n][2 * r] * inv);
      if (c + 1 < D) tc::store(orow + c + 1, acc[n][2 * r + 1] * inv);
    }
    if (t == 0)
      lse[b * ll.b + h * ll.h + row * ll.t] = (m + log2f(lsafe)) * LN2;
  }
};

// the un-normalized state, float32 and contiguous: o (B, H, Tq, D), m in
// natural units (-inf stays -inf) and l (B, H, Tq) (B8)
struct Partial {
  float *o, *m, *l;
  int H, Tq;
  template <int DP>
  __device__ __forceinline__ void write(int b, int h, int row, int r,
                                        const float (&acc)[DP / 8][4],
                                        float mx, float lsum, int D) const {
    const int t = tc::lane_id() & 3;
    const long long st = ((long long)b * H + h) * Tq + row;
    float* orow = o + st * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < D) orow[c] = acc[n][2 * r];
      if (c + 1 < D) orow[c + 1] = acc[n][2 * r + 1];
    }
    if (t == 0) {
      m[st] = mx * LN2;
      l[st] = lsum;
    }
  }
};

// One block's work: (batch, head) (blockIdx.y, blockIdx.x), its q-tile
// from blockIdx.z (the longest first under the causal mask).
template <typename T, int DP, typename Out>
__device__ __forceinline__ void attend(const Args& a, float scale_log2,
                                       int vec16, const Out& out) {
  using C = Cfg<T, DP>;
  constexpr int SW = C::SW, BN = C::BN, TILE = C::TILE;
  constexpr bool F32 = tc::kIsF32<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);       // DP > 64: Q's own tile
  T* KV = Qs + (C::QREG ? 0 : BQ * SW);          // [STAGES][K, V][BN][SW]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nq = gridDim.z;
  const int qt = a.causal ? nq - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5;
  const int g = tc::lane_id() >> 2, t = tc::lane_id() & 3;
  const int Tq = a.Tq, D = a.D;
  // the batch row's key limit, read once: keys at or past it are neither
  // loaded nor seen by any row of the block (0: the empty state)
  const int Tk = a.kv_len ? max(0, min(a.Tk, __ldg(a.kv_len + b))) : a.Tk;
  const T* qb = static_cast<const T*>(a.q) + b * a.lq.b + h * a.lq.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.lk.b + h * a.lk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.lv.b + h * a.lv.h;

  // no row of the block sees a key at or past its last valid row's
  // limit + 1 (the min of the causal limit and the row's kv_len)
  const int k_end = key_limit(min(q0 + BQ, Tq) - 1, a.koff, Tk, a.causal) + 1;
  const int nk = (k_end + BN - 1) / BN;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int lim[2] = {key_limit(row0, a.koff, Tk, a.causal),
                      key_limit(row0 + 8, a.koff, Tk, a.causal)};
  const int lim_lo = key_limit(q0, a.koff, Tk, a.causal);

  float acc[DP / 8][4];
  tc::zero(acc);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's part of each row's sum

  if (nk > 0) {  // else the block sees no key: the empty state
    T* Qtile = C::QREG ? KV + 2 * TILE : Qs;
    tc::stage<T, BQ, DP, SW, NT>(Qtile, qb, a.lq.t, q0, Tq, D, vec16);
    tc::stage<T, BN, DP, SW, NT>(KV, kb, a.lk.t, 0, k_end, D, vec16);
    tc::stage<T, BN, DP, SW, NT>(KV + TILE, vb, a.lv.t, 0, k_end, D, vec16);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();

    constexpr int QK = C::QREG ? (F32 ? DP / 8 : DP / 16) : 1;  // k-steps
    uint32_t qa[QK][4], qs[F32 ? QK : 1][4];
    if constexpr (C::QREG) {
#pragma unroll
      for (int ks = 0; ks < QK; ++ks) {
        if constexpr (F32) {
          float f[4];
          tc::frag_a<SW>(f, Qtile, warp * 16, ks * 8);
          tc::split(f, qa[ks], qs[ks]);
        } else {
          tc::frag_a16<SW>(qa[ks], Qtile, warp * 16, ks * 16);
        }
      }
    }

    for (int it = 0; it < nk; ++it) {
      // one barrier a tile: tile it has landed for every thread, and
      // every thread is done with the stage the next copy refills (tile
      // it - 1's, or, up to DP = 64, the Q tile's before the first)
      tc::cp_async_wait<0>();
      __syncthreads();
      if (it + 1 < nk) {
        T* nxt = KV + ((it + 1) % STAGES) * 2 * TILE;
        tc::stage<T, BN, DP, SW, NT>(nxt, kb, a.lk.t, (it + 1) * BN, k_end,
                                     D, vec16);
        tc::stage<T, BN, DP, SW, NT>(nxt + TILE, vb, a.lv.t, (it + 1) * BN,
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
              tc::frag_b16<SW>(r, Ks, jj * 16, ks * 16);
              const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
              tc::mma16<T>(s[2 * jj], qa[ks], b0);
              tc::mma16<T>(s[2 * jj + 1], qa[ks], b1);
            }
          }
        }
      } else {
        tc::gemm_abT<BN / 8, DP>(s, Qs, warp * 16, Ks);
      }

      // online softmax on the fragments, exp2 domain
      const bool masked = k0 + BN - 1 > lim_lo;
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = s[j][i] * scale_log2;
          if (masked && k0 + j * 8 + 2 * t + (i & 1) > lim[i >> 1])
            x = -INFINITY;
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

      // acc += P.V, a tile at a time (tc::gemm_pY_acc); bf16/fp16 round p
      tc::gemm_pY_acc<BN / 8, DP / 8, SW, !F32>(acc, s, Vs);
    }
  }

  // a row that saw no key holds m = -inf, l = 0 and o = 0 exactly (each
  // of its p was exp2(-inf) = 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const float lsum = tc::quad_sum(l[r]);
    if (row < Tq) out.template write<DP>(b, h, row, r, acc, m[r], lsum, D);
  }
}

// Launch `Kernel<T, DP>` (a __global__ that calls attend<T, DP>) over the
// grid (H, B, q-tiles) for D's bucket, after granting its shared memory;
// returns cudaGetLastError().
template <typename T, int DP, auto Kernel, typename Out>
cudaError_t launch_dp(const Args& a, const Out& out, cudaStream_t stream) {
  constexpr int bytes = Cfg<T, DP>::SMEM;
  cudaError_t e = tc::allow_smem<Kernel>(bytes);
  if (e != cudaSuccess) return e;
  const int es = (int)sizeof(T);
  const int vec16 = tc::rows16(a.q, a.lq, es) && tc::rows16(a.k, a.lk, es) &&
                    tc::rows16(a.v, a.lv, es);
  const dim3 grid(a.H, a.B, (a.Tq + BQ - 1) / BQ);
  const float scale_log2 = LOG2E / sqrtf((float)a.D);
  Kernel<<<grid, NT, bytes, stream>>>(a, scale_log2, vec16, out);
  return cudaGetLastError();
}

// the arguments every entry point checks: sizes the grid takes
inline bool bad_args(const Args& a) {
  return a.B < 1 || a.H < 1 || a.Tq < 1 || a.Tk < 1 || a.D < 1 ||
         a.D > kMaxHeadDim || a.B > 65535 || (a.Tq + BQ - 1) / BQ > 65535;
}

}  // namespace fwd
