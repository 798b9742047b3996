// LSTM recurrence over a whole sequence for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:_lstm_pallas_fwd (the Pallas
// kernel _lstm_kernel over grid=(T,), h and c in VMEM scratch).  Same
// function, float32 only: xw (T, B, 4H) is the input projection with both
// biases, gate columns [i | f | g | o]; h0, c0 (B, H); ut (H, 4H) the
// recurrent weight transposed.  Each step t:
//   pre = xw[t] + h @ ut;  c = sig(f)*c + sig(i)*tanh(g);  h = sig(o)*tanh(c)
// and y[t] = h; hT, cT are the last h and c.  expf/tanhf, no fast-math.
//
// What bounds it on the H100: the T steps are serial, each a (B, H) x
// (H, 4H) product.  Over the whole call the floor is operations,
// 2*T*B*H*4H flops at 67 TFLOP/s (bytes: xw, y, ut and the states once),
// but a step cannot start before the last one ends, so a step's latency
// decides the time: where ut lives, how many SMs share a step, and what
// they wait on.
//
// Two designs in one launch path, chosen per launch by shape (a size
// rule, not a fallback: either one's launch error is returned):
//
// 1. Cluster-resident (lstm_cluster_kernel), when a cluster's shared
//    memory holds ut: NC = 8 CTAs a cluster (16, the non-portable size,
//    where 8 do not fit), the smallest that fits.
//    * Each CTA owns U = ceil(H / NC) hidden units and keeps their columns
//      of ut, all four gates, in shared memory for all T steps (25 units
//      x 4 gates x 200 x 4 B = 80 KB at H = 200): ut is read from device
//      memory once, and each unit's gate update stays inside one CTA.
//    * A cluster owns kRows batch rows; the batch spreads over clusters
//      (B = 32: 8 clusters of 8 CTAs, 64 SMs).  Every CTA keeps the whole
//      h(t) of its rows, double-buffered.  Each step a CTA writes its
//      units' new h into every peer's next buffer through distributed
//      shared memory (mapa), then one cluster barrier (arrive.release /
//      wait.acquire) publishes it: one barrier a step, since a CTA only
//      writes the buffer its peers read a step later.
//    * kSplit = 8 threads share a unit: thread s sums k = s, s + 8, ...
//      for the unit's 4 gates and the kRows rows (16 fp32 accumulators,
//      one float4 of ut and one of h from shared memory per k, on the
//      CUDA cores: the step's product is too small for the tensor cores
//      to gain anything against the barrier), then a butterfly
//      reduce-scatter of shuffles (xor 4, 2, 1) adds the 8 partial sums
//      as ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)), leaving
//      lanes 2r and 2r + 1 with row r's four gates.  c stays in their
//      registers.
//    * ut's rows in shared memory are an odd number of float4 apart, so
//      the 8 lanes of a unit, on 8 consecutive rows, read 8 distinct bank
//      groups; h's 8 float4s are consecutive.
// 2. L2-streaming (lstm_stream_kernel), for larger H (above ~300 at 8
//    CTAs, ~450 at 16) up to kMaxHidden: one block a batch row, thread j
//    owns unit j, h in shared memory, c in a register; ut (H*4H*4 bytes)
//    is streamed from L2 every step.
// Every entry point returns cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxHidden = 1024;
constexpr int kSplit = 8;  // threads sharing one unit's sum over k
constexpr int kRows = 4;   // batch rows a cluster owns
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// ---------------------------------------------------------------------------
// 1. cluster-resident
// ---------------------------------------------------------------------------

// float4s between rows k of the resident ut: odd, so the kSplit lanes of
// a unit, on kSplit consecutive rows, read distinct bank groups
__host__ __device__ inline int ut_stride(int U) { return U | 1; }

__host__ __device__ inline size_t cluster_smem(int H, int U) {
  return (size_t)H * ut_stride(U) * 16 + 2 * (size_t)H * kRows * 4;
}

template <int NC>
__global__ void lstm_cluster_kernel(const float* __restrict__ xw,
                                    const float* __restrict__ h0,
                                    const float* __restrict__ c0,
                                    const float* __restrict__ ut,
                                    float* __restrict__ y,
                                    float* __restrict__ hT,
                                    float* __restrict__ cT, int T, int B,
                                    int H, int U) {
  extern __shared__ float4 smem4[];
  const int WS = ut_stride(U);
  float4* W = smem4;  // [H][WS]: unit u's gates i, f, g, o at row k
  // [2][H][kRows]: h(t) and h(t + 1) of the cluster's rows, all units
  float* hbuf = reinterpret_cast<float*>(smem4 + (size_t)H * WS);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int u0 = rank * U;
  const int nu = max(0, min(U, H - u0));  // units this CTA owns
  const int b0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int s = tid % kSplit;
  const int ul = tid / kSplit;
  const int uc = min(ul, U - 1);  // padding threads read a real column
  const long long G = 4LL * H;

  // the resident ut columns (zero past this CTA's units) and h0
  for (int i = tid; i < H * U; i += blockDim.x) {
    const int k = i / U, u = i % U;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u < nu) {
      const float* r = ut + k * G + u0 + u;
      w = make_float4(r[0], r[H], r[2 * H], r[3 * H]);
    }
    W[k * WS + u] = w;
  }
  for (int i = tid; i < H * kRows; i += blockDim.x) {
    const int b = b0 + i % kRows;
    hbuf[i] = b < B ? h0[(long long)b * H + i / kRows] : 0.f;
  }

  // lanes 2r and 2r + 1 of a unit's group end with row r's gates; the
  // even one stores y, hT and cT, each writes h to half of the peers
  const bool hi = s & 4, mid = s & 2, odd = s & 1;
  const int row = s >> 1;
  const int b = b0 + row;
  const bool upd = ul < nu && b < B;
  const int unit = u0 + ul;
  float c = 0.f, h = 0.f;
  if (upd) {
    c = c0[(long long)b * H + unit];
    h = h0[(long long)b * H + unit];
  }
  float x[4] = {0.f, 0.f, 0.f, 0.f};  // xw[t] of (b, unit), 4 gates
  auto load_x = [&](int t) {
    if (upd && t < T) {
      const float* p = xw + ((long long)t * B + b) * G + unit;
#pragma unroll
      for (int g = 0; g < 4; ++g) x[g] = p[g * H];
    }
  };
  load_x(0);
  // every CTA of the cluster has started and holds its ut and h0
  cluster.sync();

  for (int t = 0; t < T; ++t) {
    const float4* hp =
        reinterpret_cast<const float4*>(hbuf + (t & 1) * H * kRows);
    float* hn = hbuf + ((t + 1) & 1) * H * kRows;

    // partial sums over k = s, s + kSplit, ...: acc[r * 4 + gate]
    float acc[kRows * 4];
#pragma unroll
    for (int i = 0; i < kRows * 4; ++i) acc[i] = 0.f;
#pragma unroll 5
    for (int k = s; k < H; k += kSplit) {
      const float4 w = W[k * WS + uc];
      const float4 hv = hp[k];
      const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc[r * 4 + 0] = fmaf(hr[r], w.x, acc[r * 4 + 0]);
        acc[r * 4 + 1] = fmaf(hr[r], w.y, acc[r * 4 + 1]);
        acc[r * 4 + 2] = fmaf(hr[r], w.z, acc[r * 4 + 2]);
        acc[r * 4 + 3] = fmaf(hr[r], w.w, acc[r * 4 + 3]);
      }
    }

    // reduce-scatter over the 8 lanes: xor 4 keeps rows {0,1} / {2,3},
    // xor 2 one row of the pair, xor 1 gates {i,f} / {g,o}
    float a8[8], a4[4], a2[2];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float send = hi ? acc[i] : acc[8 + i];
      const float keep = hi ? acc[8 + i] : acc[i];
      a8[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float send = mid ? a8[i] : a8[4 + i];
      const float keep = mid ? a8[4 + i] : a8[i];
      a4[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = odd ? a4[i] : a4[2 + i];
      const float keep = odd ? a4[2 + i] : a4[i];
      a2[i] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
    }
    const float o0 = __shfl_xor_sync(0xffffffffu, a2[0], 1);
    const float o1 = __shfl_xor_sync(0xffffffffu, a2[1], 1);
    const float pi = x[0] + (odd ? o0 : a2[0]);
    const float pf = x[1] + (odd ? o1 : a2[1]);
    const float pg = x[2] + (odd ? a2[0] : o0);
    const float po = x[3] + (odd ? a2[1] : o1);

    if (upd) {
      c = sigmoid(pf) * c + sigmoid(pi) * tanhf(pg);
      h = sigmoid(po) * tanhf(c);
      float* dst = hn + unit * kRows + row;
#pragma unroll
      for (int p = odd; p < NC; p += 2) *cluster.map_shared_rank(dst, p) = h;
    }
    // release this step's writes; the wait below acquires the peers'
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    if (upd && !odd) y[((long long)t * B + b) * H + unit] = h;
    load_x(t + 1);
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
  }
  if (upd && !odd) {
    hT[(long long)b * H + unit] = h;
    cT[(long long)b * H + unit] = c;
  }
}

// ---------------------------------------------------------------------------
// 2. L2-streaming
// ---------------------------------------------------------------------------

__global__ void lstm_stream_kernel(const float* __restrict__ xw,
                                   const float* __restrict__ h0,
                                   const float* __restrict__ c0,
                                   const float* __restrict__ ut,
                                   float* __restrict__ y,
                                   float* __restrict__ hT,
                                   float* __restrict__ cT, int T, int B,
                                   int H) {
  extern __shared__ float hs[];  // [2][H]: h(t-1) and h(t)
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const bool own = j < H;
  const long G = 4L * H;
  float h = 0.f, c = 0.f;
  if (own) {
    h = h0[(long)b * H + j];
    c = c0[(long)b * H + j];
    hs[j] = h;
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* hp = hs + (t & 1) * H;
    float* hn = hs + ((t + 1) & 1) * H;
    if (own) {
      const float* x = xw + ((long)t * B + b) * G + j;
      float ai = x[0], af = x[H], ag = x[2 * H], ao = x[3 * H];
      const float* u = ut + j;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float hk = hp[k];
        const float* r = u + k * G;
        ai = fmaf(hk, r[0], ai);
        af = fmaf(hk, r[H], af);
        ag = fmaf(hk, r[2 * H], ag);
        ao = fmaf(hk, r[3 * H], ao);
      }
      c = sigmoid(af) * c + sigmoid(ai) * tanhf(ag);
      h = sigmoid(ao) * tanhf(c);
      hn[j] = h;
      y[((long)t * B + b) * H + j] = h;
    }
    __syncthreads();
  }
  if (own) {
    hT[(long)b * H + j] = h;
    cT[(long)b * H + j] = c;
  }
}

// CTAs a cluster for hidden size H: 8, else 16, the smallest whose shared
// memory holds a CTA's ut columns and h; 0: the streaming kernel
int cluster_size(int H) {
  for (int nc = 8; nc <= 16; nc *= 2)
    if (cluster_smem(H, (H + nc - 1) / nc) <= kMaxSmem) return nc;
  return 0;
}

template <int NC>
cudaError_t launch_cluster(const float* xw, const float* h0, const float* c0,
                           const float* ut, float* y, float* hT, float* cT,
                           int T, int B, int H, cudaStream_t stream) {
  const int U = (H + NC - 1) / NC;
  const size_t smem = cluster_smem(H, U);
  auto kernel = lstm_cluster_kernel<NC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (NC > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NC, (B + kRows - 1) / kRows, 1);
  cfg.blockDim = dim3((U * kSplit + 31) / 32 * 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, xw, h0, c0, ut, y, hT, cT, T, B, H,
                            U);
}

}  // namespace

extern "C" int lstm_scan(const void* xw, const void* h0, const void* c0,
                         const void* ut, void* y, void* hT, void* cT, int T,
                         int B, int H, void* stream) {
  if (T < 0 || B < 1 || H < 1 || H > kMaxHidden ||
      (B + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  const auto* x = static_cast<const float*>(xw);
  const auto* h = static_cast<const float*>(h0);
  const auto* c = static_cast<const float*>(c0);
  const auto* u = static_cast<const float*>(ut);
  auto* yo = static_cast<float*>(y);
  auto* ho = static_cast<float*>(hT);
  auto* co = static_cast<float*>(cT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (cluster_size(H)) {
    case 8:
      e = launch_cluster<8>(x, h, c, u, yo, ho, co, T, B, H, s);
      break;
    case 16:
      e = launch_cluster<16>(x, h, c, u, yo, ho, co, T, B, H, s);
      break;
    default:
      lstm_stream_kernel<<<B, (H + 31) / 32 * 32,
                           2 * (size_t)H * sizeof(float), s>>>(
          x, h, c, u, yo, ho, co, T, B, H);
      e = cudaSuccess;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the design a launch at hidden size H takes: the CTAs a cluster of the
// cluster-resident kernel (8 or 16), or 0 for the L2-streaming kernel;
// for chip_smoke.py's report
extern "C" int lstm_scan_cluster_size(int H) { return cluster_size(H); }
