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
// accuracy.  bf16 and fp16: Q.K^T on the type's tensor cores; P is rounded
// to the input type before P.V (p.astype(v.dtype)), which then runs on
// those tensor cores; the row sum l is taken over fp32 p.
//
// Layout: every tensor is addressed through its own (batch, head, row)
// element strides, lanes contiguous.  blockwise_attention hands the kernel
// BTHD and BHTD views alike, with no transpose copy; o is written through
// its own strides (the wrapper gives it q's layout).  lse is contiguous.
//
// What bounds it on the H100: the work.  Causal attention at B=8, H=12,
// T=1024, D=64 is ~12.9 GFLOP against ~100 MB (fp32), far above the
// memory line.  Split TF32 runs three TF32 products for each fp32 one:
// 495 / 3 = 165 TFLOP/s in effect; bf16 and fp16 run at up to 989 TFLOP/s.
//
// Design: the body is fwd::attend (attention_fwd.cuh), shared with B1's
// forward and B8; here its causal mask is aligned at position 0 (koff 0:
// a row with q_pos >= Tk sees every key) and the Normalized epilogue
// writes o through o's strides and lse contiguous.
// Every entry point returns cudaGetLastError() after its launch.

#include "attention_fwd.cuh"

namespace {

template <typename T, int DP>
__global__ void __launch_bounds__(fwd::NT)
mha_fwd_kernel(fwd::Args a, float scale_log2, int vec16,
               fwd::Normalized<T> out) {
  fwd::attend<T, DP>(a, scale_log2, vec16, out);
}

template <typename T>
cudaError_t launch(const fwd::Args& a, const fwd::Normalized<T>& out,
                   cudaStream_t s) {
  if (a.D <= 32)
    return fwd::launch_dp<T, 32, &mha_fwd_kernel<T, 32>>(a, out, s);
  if (a.D <= 64)
    return fwd::launch_dp<T, 64, &mha_fwd_kernel<T, 64>>(a, out, s);
  if (a.D <= 96)
    return fwd::launch_dp<T, 96, &mha_fwd_kernel<T, 96>>(a, out, s);
  return fwd::launch_dp<T, 128, &mha_fwd_kernel<T, 128>>(a, out, s);
}

}  // namespace

// strides: 12 element strides, (batch, head, row) of q, k, v and o in that
// order.  dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and o share
// it; lse is float32 (B, H, Tq), contiguous).
extern "C" int flash_mha_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const long long* strides,
                             int B, int H, int Tq, int Tk, int D, int causal,
                             int dtype, void* stream) {
  tc::Layout ls[4];
  for (int i = 0; i < 4; ++i)
    ls[i] = tc::Layout{strides[3 * i], strides[3 * i + 1],
                       strides[3 * i + 2]};
  const fwd::Args a{q, k, v, ls[0], ls[1], ls[2], B, H, Tq, Tk, D, causal, 0,
                    nullptr};
  if (fwd::bad_args(a)) return (int)cudaErrorInvalidValue;
  const tc::Layout ll{(long long)H * Tq, Tq, 1};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(
        a, fwd::Normalized<float>{static_cast<float*>(o), l, ls[3], ll}, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(
        a,
        fwd::Normalized<__nv_bfloat16>{static_cast<__nv_bfloat16*>(o), l,
                                       ls[3], ll},
        s);
  if (dtype == 2)
    return (int)launch<__half>(
        a, fwd::Normalized<__half>{static_cast<__half*>(o), l, ls[3], ll},
        s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory a block of the kernel takes at head width D, for
// chip_smoke.py's resource report (dtype as above)
extern "C" int flash_mha_smem_bytes(int D, int dtype) {
  return dtype == 0   ? fwd::smem_of<float>(D)
         : dtype == 1 ? fwd::smem_of<__nv_bfloat16>(D)
                      : fwd::smem_of<__half>(D);
}
