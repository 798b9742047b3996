// Packed-QKV flash attention, forward, for Hopper (sm_90a), on the tensor
// cores.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:_mhap_fwd (the Pallas kernel
// _mhap_fwd_kernel behind flash_mha_packed).  Same function: attention read
// straight off the fused QKV projection output qkv (B, T, 3*H*D), laid out
// [q | k | v] with head h on lanes [h*D, (h+1)*D) of each third, written
// straight into o (B, T, H*D) with no transposes, plus the log-sum-exp of
// each row for the backward.
//
// Rounding, as the TPU kernel's: scores s = (q.k^T) * scale*log2(e) in the
// exp2 domain, accumulated in fp32.  fp32: Q.K^T and P.V each as split
// TF32 (three tensor-core products, tensor_core.cuh), which keeps fp32's
// accuracy.  bf16: Q.K^T on bf16 tensor cores; P is rounded to bf16 before
// P.V (p.astype(v.dtype)), which then runs on bf16 tensor cores; the row
// sum l is taken over fp32 p.
//
// What bounds it on the H100: the work.  Causal attention at B=8, T=1024,
// H=12, D=64 is ~12.9 GFLOP against ~100 MB of traffic (fp32): far above
// the memory line.  Split TF32 runs three TF32 products for each fp32 one:
// 495 / 3 = 165 TFLOP/s in effect; bf16 runs at up to 989 TFLOP/s.
//
// Design:
// * mma.sync (m16n8k8 TF32, m16n8k16 bf16), not wgmma: wgmma reads a TF32
//   operand from shared memory only K-major, and V in P.V is MN-major, so
//   fp32 would need V staged transposed by threads; mma.sync takes every
//   operand from registers, loaded from padded shared tiles without bank
//   conflicts, and keeps P in registers between the two products (as
//   PyTorch's memory-efficient SDPA runs fp32).
// * A block of 4 warps owns 64 query rows of one (batch, head); a warp owns
//   16.  Its Q fragments (split into big and small in fp32) stay in
//   registers; S, the online-softmax state (m, l) and the output
//   accumulator live in accumulator fragments.  Each tile's P.V is summed
//   in a fresh accumulator and added to the output's on the CUDA cores
//   (tc::gemm_pY_acc: the tensor cores' accumulation does not round to
//   nearest).  The loop over 64-key tiles inside the block takes the place
//   of the TPU grid's sequential axis.
// * K and V tiles stream through a two-stage cp.async ring (16 bytes a
//   thread where qkv is 16-byte aligned), so one tile's copy overlaps the
//   previous tile's products; one barrier a tile.
// * Masks (causal, the T tail) are applied on the fragments, on the tiles
//   that need them; causal blocks stop at the diagonal, and the longest
//   q-tiles launch first so the last wave is not all short tiles.
// * lse is written as (B, T, H) float32 in natural-log units; the TPU
//   kernel's is log2 and broadcast over D.
// * Built for D = 64, the head width of the transformer_lm configurations
//   served so far.
// Every entry point returns cudaGetLastError() after its launch.

#include "tensor_core.cuh"

namespace {

constexpr int D = 64;        // head width
constexpr int BQ = 64;       // query rows per block, 16 per warp
constexpr int BN = 64;       // key rows per tile
constexpr int NT = 128;      // threads per block
constexpr int STAGES = 2;    // K/V tiles in flight
constexpr float LN2 = 0.6931471805599453f;

template <typename T>
constexpr int smem_bytes() {
  return STAGES * 2 * BN * tc::stride<T>(D) * (int)sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(NT)
mhap_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ o,
                float* __restrict__ lse, int T_, int H, int causal,
                float scale_log2, int vec16) {
  constexpr int SW = tc::stride<T>(D);
  constexpr int TILE = BN * SW;
  constexpr bool F32 = tc::kIsF32<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);  // [STAGES][K, V][BN][SW]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nq = gridDim.z;
  const int qt = causal ? nq - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int HD = H * D;
  const long long rs = 3LL * HD;  // elements between consecutive tokens
  const T* qb = qkv + (long long)b * T_ * rs + h * D;
  const T* kb = qb + HD;
  const T* vb = qb + 2 * HD;

  const int q_last = min(T_, q0 + BQ) - 1;
  const int k_end = causal ? q_last + 1 : T_;
  const int nk = (k_end + BN - 1) / BN;

  // Q goes through stage 1's K slot before the loop needs it
  tc::stage<T, BQ, D, SW, NT>(sm + 2 * TILE, qb, rs, q0, T_, D, vec16);
  tc::stage<T, BN, D, SW, NT>(sm, kb, rs, 0, T_, D, vec16);
  tc::stage<T, BN, D, SW, NT>(sm + TILE, vb, rs, 0, T_, D, vec16);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  constexpr int QK = F32 ? D / 8 : D / 16;  // k-steps over D
  uint32_t qa[QK][4], qs[F32 ? QK : 1][4];
#pragma unroll
  for (int ks = 0; ks < QK; ++ks) {
    if constexpr (F32) {
      float a[4];
      tc::frag_a<SW>(a, sm + 2 * TILE, warp * 16, ks * 8);
      tc::split(a, qa[ks], qs[ks]);
    } else {
      tc::frag_a_bf16<SW>(qa[ks], sm + 2 * TILE, warp * 16, ks * 16);
    }
  }

  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  float acc[D / 8][4];
  tc::zero(acc);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's part of each row's sum

  for (int it = 0; it < nk; ++it) {
    // one barrier a tile: tile it has landed for every thread, and every
    // thread is done with the stage the next copy refills (tile it - 1's,
    // or the Q tile's before the first)
    tc::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < nk) {
      T* nxt = sm + ((it + 1) % STAGES) * 2 * TILE;
      tc::stage<T, BN, D, SW, NT>(nxt, kb, rs, (it + 1) * BN, T_, D, vec16);
      tc::stage<T, BN, D, SW, NT>(nxt + TILE, vb, rs, (it + 1) * BN, T_, D,
                                  vec16);
    }
    tc::cp_async_commit();
    const T* Ks = sm + (it % STAGES) * 2 * TILE;
    const T* Vs = Ks + TILE;
    const int k0 = it * BN;

    // S = Q.K^T (16 x 64 per warp)
    float s[BN / 8][4];
    tc::zero(s);
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

    // online softmax on the fragments, exp2 domain
    const bool masked = k0 + BN > T_ || (causal && k0 + BN - 1 > q0);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[j][i] * scale_log2;
        if (masked) {
          const int col = k0 + j * 8 + 2 * t + (i & 1);
          const int row = row0 + (i >> 1) * 8;
          if (col >= T_ || (causal && col > row)) x = -INFINITY;
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
      for (int n = 0; n < D / 8; ++n) {
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
    tc::gemm_pY_acc<BN / 8, D / 8, SW, !F32>(acc, s, Vs);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const float lsafe = fmaxf(tc::quad_sum(l[r]), 1e-30f);
    if (row >= T_) continue;
    const float inv = 1.f / lsafe;
    T* orow = o + ((long long)b * T_ + row) * HD + h * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      tc::store(orow + n * 8, acc[n][2 * r] * inv);
      tc::store(orow + n * 8 + 1, acc[n][2 * r + 1] * inv);
    }
    if (t == 0)
      lse[((long long)b * T_ + row) * H + h] = (m[r] + log2f(lsafe)) * LN2;
  }
}

template <typename T>
cudaError_t launch(const void* qkv, void* o, void* lse, int B, int T_,
                   int H, int causal, cudaStream_t stream) {
  const int bytes = smem_bytes<T>();
  cudaError_t e = tc::allow_smem<&mhap_fwd_kernel<T>>(bytes);
  if (e != cudaSuccess) return e;
  const int nq = (T_ + BQ - 1) / BQ;
  // every row of qkv starts 16-byte aligned when its base does (D = 64)
  const int vec16 = reinterpret_cast<uintptr_t>(qkv) % 16 == 0;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  mhap_fwd_kernel<T><<<dim3(H, B, nq), NT, bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(o),
      static_cast<float*>(lse), T_, H, causal, scale_log2, vec16);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (qkv and o share it; lse is float32).
extern "C" int flash_mha_packed_fwd(const void* qkv, void* o, void* lse,
                                    int B, int T, int H, int D_, int causal,
                                    int dtype, void* stream) {
  if (B < 1 || T < 1 || H < 1 || B > 65535 || D_ != D ||
      (T + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(qkv, o, lse, B, T, H, causal, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(qkv, o, lse, B, T, H, causal, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory a block of the kernel takes, for chip_smoke.py's
// resource report (dtype as above)
extern "C" int flash_mha_packed_smem_bytes(int dtype) {
  return dtype == 0 ? smem_bytes<float>() : smem_bytes<__nv_bfloat16>();
}
