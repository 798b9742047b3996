// LSTM recurrence over a whole sequence for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:_lstm_pallas_fwd (the Pallas
// kernel _lstm_kernel over grid=(T,), h and c in VMEM scratch).  Same
// function, float32 only: xw (T, B, 4H) is the input projection with both
// biases, gate columns [i | f | g | o]; h0, c0 (B, H); ut (H, 4H) the
// recurrent weight transposed.  Each step t:
//   pre = xw[t] + h @ ut;  c = sig(f)*c + sig(i)*tanh(g);  h = sig(o)*tanh(c)
// and y[t] = h; hT, cT are the last h and c.
//
// What bounds it on the H100: the T steps are serial, each a (B, H) x
// (H, 4H) product.  Over the whole call the floor is operations,
// 2*T*B*H*4H flops at 67 TFLOP/s (bytes: xw, y, ut and the states once),
// but a step cannot start before the last one ends, so a step's latency
// decides the time.
//
// Design (the simple one; a thread-block cluster that keeps ut in shared
// memory across CTAs is later work):
// * One launch for the sequence.  Batch rows are independent, so one
//   block owns one batch row for all T steps and no block waits on
//   another.  h lives in shared memory (double-buffered, so one
//   __syncthreads() a step suffices), c in the owning thread's register.
// * Thread j owns hidden unit j (blockDim = H rounded up to a warp): it
//   sums the four gate pre-activations of unit j over k, reading
//   ut[k, g*H + j], coalesced across j, and h[k] from shared memory as a
//   broadcast.
// * ut (H*4H*4 bytes, 640 KB at H = 200) is larger than an SM's shared
//   memory, so every step streams it from L2, where it stays resident.
// * expf/tanhf, no fast-math.  H may be any size up to 1024.
// The entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxHidden = 1024;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void lstm_scan_kernel(const float* __restrict__ xw,
                                 const float* __restrict__ h0,
                                 const float* __restrict__ c0,
                                 const float* __restrict__ ut,
                                 float* __restrict__ y,
                                 float* __restrict__ hT,
                                 float* __restrict__ cT, int T, int B,
                                 int H) {
  extern __shared__ float hbuf[];  // [2][H]: h(t-1) and h(t)
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const bool own = j < H;
  const long G = 4L * H;
  float h = 0.f, c = 0.f;
  if (own) {
    h = h0[(long)b * H + j];
    c = c0[(long)b * H + j];
    hbuf[j] = h;
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* hp = hbuf + (t & 1) * H;
    float* hn = hbuf + ((t + 1) & 1) * H;
    if (own) {
      const float* x = xw + ((long)t * B + b) * G + j;
      float ai = x[0], af = x[H], ag = x[2 * H], ao = x[3 * H];
      const float* u = ut + j;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float hk = hp[k];
        const float* row = u + k * G;
        ai = fmaf(hk, row[0], ai);
        af = fmaf(hk, row[H], af);
        ag = fmaf(hk, row[2 * H], ag);
        ao = fmaf(hk, row[3 * H], ao);
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

}  // namespace

extern "C" int lstm_scan(const void* xw, const void* h0, const void* c0,
                         const void* ut, void* y, void* hT, void* cT, int T,
                         int B, int H, void* stream) {
  if (T < 0 || B < 1 || H < 1 || H > kMaxHidden)
    return (int)cudaErrorInvalidValue;
  const int threads = (H + 31) / 32 * 32;
  const size_t smem = 2 * (size_t)H * sizeof(float);
  lstm_scan_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xw), static_cast<const float*>(h0),
      static_cast<const float*>(c0), static_cast<const float*>(ut),
      static_cast<float*>(y), static_cast<float*>(hT),
      static_cast<float*>(cT), T, B, H);
  return (int)cudaGetLastError();
}
