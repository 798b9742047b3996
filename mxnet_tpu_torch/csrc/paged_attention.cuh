// The one kernel of the paged attention entry points for Hopper (sm_90a):
// paged_attention_decode.cu (B2), paged_attention_decode_quant.cu (B3)
// and paged_attention_verify.cu (B4, raw and quantized pages).
//
// attend_kernel is the work of one thread-block cluster for one (stream,
// head): W query rows, row w at position len_w - 1 against the first
// len_w = lens[b] + add + w cached tokens of the stream, read through its
// block-table row.  The verify kernels launch it with add = 1 (lens =
// start) and the decode kernels with W = 1 and add = 0 (lens = lengths):
// a verify row w and the decode step at lengths = start + 1 + w execute
// the same operations on the same bytes and agree bit for bit (the JAX
// package's "verify row == decode step" contract, rebuilt between the
// port's kernels).  That holds because the work partition below depends
// on the page and token index alone, never on B, W, MB or a length: a
// row's state only ever meets the tokens it would meet in the decode
// step, in the same groups and the same order; and because a row's
// arithmetic is explicit (fmaf, no product left for the compiler to
// contract), so the one-row instantiation (W = 1) and the eight-row one
// compute it alike.
//
// * One cluster of NC CTAs a (stream, head).  CTA c takes pages c, c + NC,
//   ...; warp w of a CTA takes every NW-th of those.  Each live page's K
//   and V head slice (KVB rows of D elements at a stride of H * D) is read
//   once for the whole window and folded into the W rows' online-softmax
//   states (m, l, acc), WC rows a pass (W > WC loops over passes, each
//   reading the pages again).  The rows a pass are a template constant NR:
//   1 for W = 1 (the decode kernels and a one-row verify), WC otherwise; a
//   row's arithmetic is the same sequence of operations in both.
// * A warp streams its pages in tiles of TT tokens of one page (16; 8 when
//   a row is over 256 bytes) through a two-buffer stage in shared memory:
//   cp.async copies (16 bytes, .cg, where D * element size and the pools'
//   addresses allow: 16 lanes a 256-byte fp32 row, 8 a bf16 or fp16 row,
//   4 an int8 row; 8 or 4 bytes else; plain 2- or 1-byte copies for odd widths) of
//   the next tile's K and V rows (and, over quantized pools, their scales)
//   are in flight while a tile is computed.  Tokens past the longest row
//   are not copied.  Stage rows are padded to an odd number of 16-byte
//   units, so the reads below are free of bank conflicts.
// * q.k: LT = 32 / TT lanes a token, each dotting its part of the row
//   against q from shared memory (fp32, scaled), then log2(LT) shuffles
//   (one at TT = 16).  One online-softmax update a row and tile (the max
//   over the tile's tokens in log2(TT) shuffles, one exp a token); tiles
//   start at fixed page positions.  p.v: each lane accumulates DP / 32
//   head lanes of every row, the weights read from shared memory four
//   tokens at a time.  Every row of a pass runs the same straight-line
//   code (no branch per row, so the rows' shuffle and exp chains overlap;
//   rows past W have zero q and are never stored).  A token past a row's
//   length is an exact no-op of that row (weight 0), and so is a tile with
//   none of its tokens (alpha 1, weights 0).
// * Merge: each warp's state (l summed over its lanes in a fixed
//   butterfly) goes to shared memory, the CTA merges its warps in order,
//   then rank 0 merges the NC CTA states in rank order through distributed
//   shared memory (cluster.map_shared_rank, between two cluster barriers)
//   and writes the rows.  A state that saw no token contributes nothing;
//   len == 0 gives zeros, never NaN.
// * Page readers: RawPages reads fp32/bf16/fp16 values, QuantPages int8 or
//   fp8-e4m3 codes times the row's fp32 scale, dequantized after the copy
//   as float(code) * scale, as the TPU kernel does.  Rows are numbered r =
//   (page * KVB + slot) * H + head: values start at r * D, the (P, KVB, H)
//   scale pools hold one float at r.
// * Head widths: DP, the bucket (32, 64, 96, 128), is a template constant;
//   a width below it copies D elements a row and zeroes the stage's bytes
//   past them (zero q and K; those lanes' accumulators are never stored).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace paged {

namespace cg = cooperative_groups;

constexpr int NC = 8;   // CTAs a cluster (the portable size): one (b, h)
constexpr int NW = 2;   // warps a CTA
constexpr int WC = 8;   // query rows a pass
constexpr int kMaxHeadDim = 128;

// layout of one (bucket, pool element) instantiation, sizes in bytes
template <int DP, int ES, bool Scaled>
struct Geom {
  static constexpr int ROW = DP * ES;            // a token's K or V row
  static constexpr int TT = ROW > 256 ? 8 : 16;  // tokens a tile
  static constexpr int LT = 32 / TT;             // lanes a token in q.k
  static constexpr int SPAN = ROW / LT;          // bytes of a row a lane dots
  static constexpr int EK = 16 / ES;             // elements a 16-byte chunk
  static constexpr int EV = DP / 32;             // head lanes a thread in p.v
  // rows 16 bytes longer than their data: an odd number of 16-byte units
  // apart, so eight lanes on eight rows read eight distinct bank groups
  static constexpr int ROWP = ROW + 16;
  static constexpr int TILE = TT * ROWP;
  static constexpr int SC = Scaled ? TT * 4 : 0;    // a tile's scales
  static constexpr int BUF = 2 * TILE + 2 * SC;     // K, V, their scales
  static constexpr int WARP = 2 * BUF;              // two buffers a warp
  static constexpr int SLOT = WC * (DP + 2) * 4;    // a merged state
  // the warps' stages, later their states; q; the weights p; the CTA's
  // state, read by rank 0; rank 0's copies of the CTAs' m and l
  static constexpr int STAGE = NW * WARP > NW * SLOT ? NW * WARP : NW * SLOT;
  static constexpr int Q = WC * DP * 4;
  static constexpr int P = NW * WC * TT * 4;
  static constexpr int BYTES = STAGE + Q + P + SLOT + 2 * NC * WC * 4;
  static_assert(SPAN % 16 == 0 && ROWP % 32 == 16 && SC % 16 == 0, "");
  static_assert(BYTES <= 48 * 1024, "no opt-in shared memory needed");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
// int8 codes are signed char, fp8-e4m3 codes unsigned char
// (__nv_fp8_storage_t)
__device__ __forceinline__ float to_f32(signed char x) { return (float)x; }
__device__ __forceinline__ float to_f32(unsigned char x) {
  // every e4m3 value is exact in fp16, and fp16 in fp32
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, __NV_E4M3)));
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

template <typename TKV>
struct RawPages {
  using Elem = TKV;
  static constexpr bool kScaled = false;
  const TKV* __restrict__ k;
  const TKV* __restrict__ v;
  __host__ __device__ const float* ks() const { return nullptr; }
  __host__ __device__ const float* vs() const { return nullptr; }
};

template <typename TC>
struct QuantPages {
  using Elem = TC;
  static constexpr bool kScaled = true;
  const TC* __restrict__ k;
  const TC* __restrict__ v;
  const float* __restrict__ kscale;
  const float* __restrict__ vscale;
  __host__ __device__ const float* ks() const { return kscale; }
  __host__ __device__ const float* vs() const { return vscale; }
};

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

template <int N>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)), "l"(src) : "memory");
  } else if constexpr (N == 8 || N == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "n"(N) : "memory");
  } else if constexpr (N == 2) {  // no cp.async this narrow: load, store
    *static_cast<unsigned short*>(dst) =
        *static_cast<const unsigned short*>(src);
  } else {
    *static_cast<unsigned char*>(dst) = *static_cast<const unsigned char*>(src);
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n rows of `bytes` bytes, `stride` bytes apart in device memory, into
// rows `ROWP` bytes apart in the stage; the warp's lanes take VEC-byte
// pieces in turn (at VEC = 16 and 256-byte rows: 16 lanes a row)
template <int VEC, int ROWP>
__device__ __forceinline__ void copy_rows(unsigned char* dst,
                                          const unsigned char* src,
                                          long stride, int n, int bytes,
                                          int lane) {
  const int per_row = bytes / VEC;
  const int total = n * per_row;
  for (int i = lane; i < total; i += 32) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * VEC;
    copy_async<VEC>(dst + r * ROWP + c, src + r * stride + c);
  }
}

// E values at p (shared memory) as fp32: one 16-, 8- or 4-byte load where
// E * element size is one of those
template <int E, typename T>
__device__ __forceinline__ void load_vals(const unsigned char* p,
                                          float (&x)[E]) {
  constexpr int NB = E * (int)sizeof(T);
  if constexpr (NB == 16 || NB == 8 || NB == 4) {
    using V = std::conditional_t<NB == 16, uint4,
                                 std::conditional_t<NB == 8, uint2, unsigned>>;
    const V raw = *reinterpret_cast<const V*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) x[i] = to_f32(e[i]);
  } else {
    const T* e = reinterpret_cast<const T*>(p);
#pragma unroll
    for (int i = 0; i < E; ++i) x[i] = to_f32(e[i]);
  }
}

// the factor of a state in a merge: exp(m_i - M), 0 for an empty state
__device__ __forceinline__ float merge_factor(float mi, float M) {
  return mi == -INFINITY ? 0.f : expf(mi - M);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// grid (NC * B, H), clusters of NC along x.  q (B, W, H, D) with batch and
// row strides given, head and lane strides D and 1; out (B, W, H, D)
// contiguous; D <= DP, the bucket.  NR: query rows a pass as a constant
// (1 for W = 1, else WC; a row's arithmetic is the same in both).  vec:
// the widest copy (16, 8, 4, 2 or 1 bytes) the pools' addresses and the
// row width allow.
// The one-row instantiation is held to 80 registers (12 CTAs an SM by
// registers): decode is latency-bound and gains from the CTAs in flight;
// the WC-row one keeps its registers (a cap spills its rows' ILP).
template <typename TQ, int DP, int NR, typename Pages>
__global__ void __launch_bounds__(NW * 32, NR == 1 ? 12 : 1)
attend_kernel(const TQ* __restrict__ q, long q_batch_stride,
              long q_row_stride, const Pages pages,
              const int* __restrict__ table, const int* __restrict__ lens,
              int add, TQ* __restrict__ out, int W, int H, int D, int KVB,
              int MB, float scale, int vec) {
  using T = typename Pages::Elem;
  constexpr int ES = (int)sizeof(T);
  using GM = Geom<DP, ES, Pages::kScaled>;
  constexpr int TT = GM::TT, LT = GM::LT, EK = GM::EK, EV = GM::EV;
  constexpr int ROWP = GM::ROWP, RS = DP + 2;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / NC;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane % TT;  // q.k: the tile row this lane dots
  const int sq = lane / TT;  // ... its SPAN-byte part of that row

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage = smem + warp * GM::WARP;
  float* slots = reinterpret_cast<float*>(smem);  // over the stage
  float* qs = reinterpret_cast<float*>(smem + GM::STAGE);  // [WC][DP]
  float* pw = qs + WC * DP + warp * WC * TT;               // [WC][TT]
  float* cta = qs + WC * DP + NW * WC * TT;                // [WC][RS]
  float* peer_m = cta + WC * RS;
  float* peer_l = peer_m + NC * WC;

  const int* table_row = table + (long)b * MB;
  const int jstep = NC * NW;
  const int j0 = rank + NC * warp;  // this warp's first page
  const int page0 = j0 < MB ? table_row[j0] : 0;  // in flight with lens[b]
  const int base = lens[b] + add;  // row w sees base + w tokens
  const long tok_bytes = (long)H * D * ES;  // slot to slot in the pools
  const int row_bytes = D * ES;

  for (int w0 = 0; w0 < W; w0 += WC) {
    const int nrow = min(NR, W - w0);
    // tokens the pass reads: the longest row's, within the table
    const int lmax = max(0, min(base + w0 + nrow - 1, MB * KVB));
    const int npages = (lmax + KVB - 1) / KVB;

    if (row_bytes < GM::ROW) {  // the stage's row bytes past D read as
      // zeros (every pass: the last one's merge wrote over the stage)
      const int pad = GM::ROW - row_bytes;
      for (int i = lane; i < 4 * TT * pad; i += 32) {
        const int r = i / pad, tile = r / TT;  // K, V of buffer 0, then 1
        stage[(tile >> 1) * GM::BUF + (tile & 1) * GM::TILE + (r % TT) * ROWP +
              row_bytes + (i - r * pad)] = 0;
      }
    }

    // the copy cursor: tile (lj, lt), lpage = table_row[lj]
    int lj = j0, lt = 0, lpage = page0;
    auto issue = [&](int buf) {
      if (lj < npages) {
        const int live = min(KVB, lmax - lj * KVB);
        const int n = min(TT, live - lt);
        const long r0 = ((long)lpage * KVB + lt) * H + h;
        unsigned char* kb = stage + buf * GM::BUF;
        unsigned char* vb = kb + GM::TILE;
        const unsigned char* ksrc =
            reinterpret_cast<const unsigned char*>(pages.k + r0 * D);
        const unsigned char* vsrc =
            reinterpret_cast<const unsigned char*>(pages.v + r0 * D);
        auto rows = [&](auto vb_) {
          constexpr int VB = decltype(vb_)::value;
          copy_rows<VB, ROWP>(kb, ksrc, tok_bytes, n, row_bytes, lane);
          copy_rows<VB, ROWP>(vb, vsrc, tok_bytes, n, row_bytes, lane);
        };
        if (vec == 16 && row_bytes == GM::ROW) {  // the exact width
          copy_rows<16, ROWP>(kb, ksrc, tok_bytes, n, GM::ROW, lane);
          copy_rows<16, ROWP>(vb, vsrc, tok_bytes, n, GM::ROW, lane);
        } else if (vec == 16) rows(std::integral_constant<int, 16>{});
        else if (vec == 8) rows(std::integral_constant<int, 8>{});
        else if (vec == 4) rows(std::integral_constant<int, 4>{});
        else if (vec == 2) rows(std::integral_constant<int, 2>{});
        else rows(std::integral_constant<int, 1>{});
        if constexpr (Pages::kScaled) {
          float* sb = reinterpret_cast<float*>(vb + GM::TILE);
          if (lane < n) {
            copy_async<4>(sb + lane, pages.ks() + r0 + (long)lane * H);
            copy_async<4>(sb + TT + lane, pages.vs() + r0 + (long)lane * H);
          }
        }
        lt += TT;
        if (lt >= live) {
          lj += jstep;
          lt = 0;
          if (lj < npages) lpage = table_row[lj];
        }
      }
      copy_commit();  // an empty group past the last tile
    };
    issue(0);
    issue(1);

    // the pass's q rows, scaled, zero past D
    for (int x = threadIdx.x; x < NR * DP; x += NW * 32) {
      const int w = x / DP, e = x - w * DP;
      qs[x] = w < nrow && e < D
                  ? to_f32(q[(long)b * q_batch_stride +
                             (long)(w0 + w) * q_row_stride + (long)h * D +
                             e]) * scale
                  : 0.f;
    }
    __syncthreads();

    float acc[NR][EV], m[NR], l[NR];
#pragma unroll
    for (int w = 0; w < NR; ++w) {
#pragma unroll
      for (int e = 0; e < EV; ++e) acc[w][e] = 0.f;
      m[w] = -INFINITY;
      l[w] = 0.f;
    }

    // the compute cursor: tile (cj, ct) in buffer cb
    int cj = j0, ct = 0, cb = 0;
    while (cj < npages) {
      const int live = min(KVB, lmax - cj * KVB);
      const int n = min(TT, live - ct);
      const int tile_pos = cj * KVB + ct;  // the tile's first token
      copy_wait<1>();
      __syncwarp();
      const unsigned char* kb = stage + cb * GM::BUF;
      const unsigned char* vb = kb + GM::TILE;
      const float* sb = reinterpret_cast<const float*>(vb + GM::TILE);

      // q.k: lanes (tq, sq) dot SPAN bytes of row tq, every row of the
      // pass at once (rows past nrow have zero q), then the row's LT lanes
      // add their parts (log2(LT) shuffles)
      float d[NR];
#pragma unroll
      for (int w = 0; w < NR; ++w) d[w] = 0.f;
      if (tq < n) {
        const unsigned char* krow = kb + tq * ROWP + sq * GM::SPAN;
        const float* qp = qs + sq * (GM::SPAN / ES);
#pragma unroll
        for (int c = 0; c < GM::SPAN / 16; ++c) {
          float kx[EK];
          load_vals<EK, T>(krow + c * 16, kx);
          if constexpr (Pages::kScaled) {
            const float ksc = sb[tq];
#pragma unroll
            for (int i = 0; i < EK; ++i) kx[i] = kx[i] * ksc;
          }
#pragma unroll
          for (int w = 0; w < NR; ++w) {
#pragma unroll
            for (int i = 0; i < EK; i += 4) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(qp + w * DP + c * EK + i);
              d[w] = fmaf(qv.x, kx[i], d[w]);
              d[w] = fmaf(qv.y, kx[i + 1], d[w]);
              d[w] = fmaf(qv.z, kx[i + 2], d[w]);
              d[w] = fmaf(qv.w, kx[i + 3], d[w]);
            }
          }
        }
      }
#pragma unroll
      for (int off = TT; off < 32; off <<= 1)
#pragma unroll
        for (int w = 0; w < NR; ++w)
          d[w] += __shfl_xor_sync(0xffffffffu, d[w], off);
      // one online-softmax update a row and tile: the tile's max over its
      // TT tokens (log2(TT) shuffles), one exp a token.  Row w's tokens
      // are the tile's first min(n, len_w - tile_pos); a tile with none
      // leaves the row's state as it was (alpha 1, weights 0).
      float mt[NR];
#pragma unroll
      for (int w = 0; w < NR; ++w) {
        const bool ok = tq < min(n, base + w0 + w - tile_pos);
        d[w] = ok ? d[w] : -INFINITY;
        mt[w] = d[w];
      }
#pragma unroll
      for (int off = 1; off < TT; off <<= 1)
#pragma unroll
        for (int w = 0; w < NR; ++w)
          mt[w] = fmaxf(mt[w], __shfl_xor_sync(0xffffffffu, mt[w], off));
#pragma unroll
      for (int w = 0; w < NR; ++w) {
        const bool live = mt[w] != -INFINITY;
        const float mn = live ? fmaxf(m[w], mt[w]) : m[w];
        const float alpha = live ? expf(m[w] - mn) : 1.f;  // 0: empty state
        const float p = d[w] != -INFINITY ? expf(d[w] - mn) : 0.f;
        l[w] = fmaf(l[w], alpha, sq == 0 ? p : 0.f);
#pragma unroll
        for (int e = 0; e < EV; ++e) acc[w][e] *= alpha;
        m[w] = mn;
        if (sq == 0) pw[w * TT + tq] = p;
      }
      __syncwarp();

      // p.v: lane covers head lanes lane * EV, ...; the weights from
      // shared memory, four tokens at a time (a token past a row's length
      // has weight 0, one not copied reads as 0)
      for (int t0 = 0; t0 < n; t0 += 4) {
        float vx[4][EV];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int e = 0; e < EV; ++e) vx[i][e] = 0.f;
          if (t0 + i < n) {
            load_vals<EV, T>(vb + (t0 + i) * ROWP + lane * EV * ES, vx[i]);
            if constexpr (Pages::kScaled) {
              const float vsc = sb[TT + t0 + i];
#pragma unroll
              for (int e = 0; e < EV; ++e) vx[i][e] = vx[i][e] * vsc;
            }
          }
        }
#pragma unroll
        for (int w = 0; w < NR; ++w) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(pw + w * TT + t0);
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < EV; ++e)
              acc[w][e] = fmaf(pv[i], vx[i][e], acc[w][e]);
        }
      }
      __syncwarp();  // every lane is done with buffer cb and the weights
      issue(cb);
      cb ^= 1;
      ct += TT;
      if (ct >= live) {
        cj += jstep;
        ct = 0;
      }
    }
    copy_wait<0>();
    __syncthreads();  // every warp is done with its stage

    // each warp's state into its slot (l summed over the lanes in a fixed
    // butterfly), then the CTA's merge in warp order
    {
      float* s = slots + warp * WC * RS;
#pragma unroll
      for (int w = 0; w < NR; ++w) {
        if (w >= nrow) continue;
        float lw = l[w];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          lw += __shfl_xor_sync(0xffffffffu, lw, off);
        if (lane == 0) {
          s[w * RS] = m[w];
          s[w * RS + 1] = lw;
        }
#pragma unroll
        for (int e = 0; e < EV; ++e) s[w * RS + 2 + lane * EV + e] = acc[w][e];
      }
    }
    __syncthreads();
    for (int x = threadIdx.x; x < nrow * DP; x += NW * 32) {
      const int w = x / DP, e = x - w * DP;
      float M = -INFINITY;
#pragma unroll
      for (int s = 0; s < NW; ++s) M = fmaxf(M, slots[(s * WC + w) * RS]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int s = 0; s < NW; ++s) {
        const float* st = slots + (s * WC + w) * RS;
        const float f = merge_factor(st[0], M);
        L = fmaf(st[1], f, L);
        A = fmaf(st[2 + e], f, A);
      }
      cta[w * RS + 2 + e] = A;
      if (e == 0) {
        cta[w * RS] = M;
        cta[w * RS + 1] = L;
      }
    }
    cluster.sync();  // every CTA's state is ready

    if (rank == 0) {  // the NC states in rank order, then the rows
      for (int x = threadIdx.x; x < NC * nrow; x += NW * 32) {
        const int c = x / nrow, w = x - c * nrow;
        const float* st = cluster.map_shared_rank(cta, c) + w * RS;
        peer_m[c * WC + w] = st[0];
        peer_l[c * WC + w] = st[1];
      }
      __syncthreads();
      for (int x = threadIdx.x; x < nrow * D; x += NW * 32) {
        const int w = x / D, e = x - w * D;
        float M = -INFINITY;
#pragma unroll
        for (int c = 0; c < NC; ++c) M = fmaxf(M, peer_m[c * WC + w]);
        float L = 0.f, A = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float f = merge_factor(peer_m[c * WC + w], M);
          L = fmaf(peer_l[c * WC + w], f, L);
          A = fmaf(cluster.map_shared_rank(cta, c)[w * RS + 2 + e], f, A);
        }
        const float inv = 1.f / fmaxf(L, 1e-30f);  // L == 0 -> zeros
        out[(((long)b * W + w0 + w) * H + h) * D + e] = from_f32<TQ>(A * inv);
      }
    }
    cluster.sync();  // rank 0 has read every peer; the stage may refill
  }
}

// the widest copy the pools' addresses and a row's D * element size allow
template <typename Pages>
int vector_bytes(const Pages& pages, int D) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(pages.k) |
                         reinterpret_cast<uintptr_t>(pages.v) |
                         (uintptr_t)(D * sizeof(typename Pages::Elem));
  int v = 16;
  while (v > 1 && (bits & (uintptr_t)(v - 1))) v >>= 1;
  return v;
}

template <typename TQ, int DP, int NR, typename Pages>
cudaError_t launch_rows(const TQ* q, long q_batch_stride, long q_row_stride,
                        const Pages& pages, const int* table, const int* lens,
                        int add, TQ* out, int B, int W, int H, int D, int KVB,
                        int MB, cudaStream_t stream) {
  using GM = Geom<DP, (int)sizeof(typename Pages::Elem), Pages::kScaled>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NC * B, H, 1);
  cfg.blockDim = dim3(NW * 32, 1, 1);
  cfg.dynamicSmemBytes = GM::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto kernel = attend_kernel<TQ, DP, NR, Pages>;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, q, q_batch_stride, q_row_stride, pages, table, lens, add,
      out, W, H, D, KVB, MB, 1.f / sqrtf((float)D), vector_bytes(pages, D));
  return e != cudaSuccess ? e : cudaGetLastError();
}

// one launch: grid (NC * B, H) in clusters of NC; lens[b] + add + w is row
// w's visible length (decode: W = 1, add = 0; verify: add = 1).  W = 1
// runs the one-row instantiation, the decode kernels' and a one-row
// verify's alike.  Window: the WC-row instantiation is built too (the
// verify libraries); the decode libraries, whose W is always 1, leave it
// out (half their compile time).
template <typename TQ, int DP, bool Window, typename Pages>
cudaError_t launch_attend(const TQ* q, long q_batch_stride, long q_row_stride,
                          const Pages& pages, const int* table,
                          const int* lens, int add, TQ* out, int B, int W,
                          int H, int D, int KVB, int MB, cudaStream_t stream) {
  if ((long)B * NC > 0x7fffffffL) return cudaErrorInvalidValue;
  if (W == 1)
    return launch_rows<TQ, DP, 1>(q, q_batch_stride, q_row_stride, pages,
                                  table, lens, add, out, B, W, H, D, KVB, MB,
                                  stream);
  if constexpr (Window)
    return launch_rows<TQ, DP, WC>(q, q_batch_stride, q_row_stride, pages,
                                   table, lens, add, out, B, W, H, D, KVB,
                                   MB, stream);
  return cudaErrorInvalidValue;
}

// the dynamic shared memory of the instantiation for bucket dp over pool
// elements of es bytes (scaled: quantized pools), 0 for no such bucket
inline int smem_bytes(int dp, int es, bool scaled) {
#define PAGED_SMEM(DP_, ES_)                                       \
  if (dp == DP_ && es == ES_)                                      \
    return scaled ? Geom<DP_, ES_, true>::BYTES : Geom<DP_, ES_, false>::BYTES;
  PAGED_SMEM(32, 4) PAGED_SMEM(32, 2) PAGED_SMEM(32, 1)
  PAGED_SMEM(64, 4) PAGED_SMEM(64, 2) PAGED_SMEM(64, 1)
  PAGED_SMEM(96, 4) PAGED_SMEM(96, 2) PAGED_SMEM(96, 1)
  PAGED_SMEM(128, 4) PAGED_SMEM(128, 2) PAGED_SMEM(128, 1)
#undef PAGED_SMEM
  return 0;
}

template <int N>
using Int = std::integral_constant<int, N>;

// launch(Int<DP>{}, std::bool_constant<D < DP>{}) for D's bucket: the
// launchers' one dispatch on the head width, so the decode and verify
// kernels run the same instantiation of attend_kernel at every D (the
// kernel takes D at run time: a width below its bucket copies D elements
// a row and reads the rest of the bucket as zeros)
template <typename F>
cudaError_t with_head_dim(int D, F&& launch) {
  using std::false_type;
  using std::true_type;
  if (D < 1 || D > kMaxHeadDim) return cudaErrorInvalidValue;
  if (D <= 32)
    return D == 32 ? launch(Int<32>{}, false_type{})
                   : launch(Int<32>{}, true_type{});
  if (D <= 64)
    return D == 64 ? launch(Int<64>{}, false_type{})
                   : launch(Int<64>{}, true_type{});
  if (D <= 96)
    return D == 96 ? launch(Int<96>{}, false_type{})
                   : launch(Int<96>{}, true_type{});
  return D == 128 ? launch(Int<128>{}, false_type{})
                  : launch(Int<128>{}, true_type{});
}

}  // namespace paged
