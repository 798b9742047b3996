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
// accuracy.  bf16 and fp16: Q.K^T on the type's tensor cores; P is rounded
// to the input type before P.V (p.astype(v.dtype)), which then runs on
// those tensor cores; the row sum l is taken over fp32 p.
//
// What bounds it on the H100: the work.  Causal attention at B=8, T=1024,
// H=12, D=64 is ~12.9 GFLOP against ~100 MB of traffic (fp32): far above
// the memory line.  Split TF32 runs three TF32 products for each fp32 one:
// 495 / 3 = 165 TFLOP/s in effect; bf16 and fp16 run at up to 989 TFLOP/s.
//
// Design: the body is fwd::attend (attention_fwd.cuh), shared with B5's
// forward and B8; the packed layout only sets the strides it reads (q, k
// and v are the thirds of qkv, 3*H*D elements between tokens, heads D
// apart), its causal mask is aligned at position 0, and the Normalized
// epilogue writes o (B, T, H*D) and lse (B, T, H), H apart: lse is in
// natural-log units, where the TPU kernel's is log2 and broadcast over D.
// Every entry point returns cudaGetLastError() after its launch.

#include "attention_fwd.cuh"

namespace {

template <typename T, int DP>
__global__ void __launch_bounds__(fwd::NT)
mhap_fwd_kernel(fwd::Args a, float scale_log2, int vec16,
                fwd::Normalized<T> out) {
  fwd::attend<T, DP>(a, scale_log2, vec16, out);
}

template <typename T>
cudaError_t launch(const fwd::Args& a, const fwd::Normalized<T>& out,
                   cudaStream_t s) {
  if (a.D <= 32)
    return fwd::launch_dp<T, 32, &mhap_fwd_kernel<T, 32>>(a, out, s);
  if (a.D <= 64)
    return fwd::launch_dp<T, 64, &mhap_fwd_kernel<T, 64>>(a, out, s);
  if (a.D <= 96)
    return fwd::launch_dp<T, 96, &mhap_fwd_kernel<T, 96>>(a, out, s);
  return fwd::launch_dp<T, 128, &mhap_fwd_kernel<T, 128>>(a, out, s);
}

template <typename T>
int run(const void* qkv, void* o, void* lse, int B, int T_, int H, int D,
        int causal, cudaStream_t s) {
  const long long HD = (long long)H * D, rs = 3 * HD;
  const tc::Layout lqkv{T_ * rs, D, rs};  // q, k, v: thirds of each token
  const T* q = static_cast<const T*>(qkv);
  const fwd::Args a{q, q + HD, q + 2 * HD, lqkv, lqkv, lqkv, B, H, T_, T_,
                    D, causal, 0, nullptr};
  if (fwd::bad_args(a)) return (int)cudaErrorInvalidValue;
  const fwd::Normalized<T> out{static_cast<T*>(o), static_cast<float*>(lse),
                               tc::Layout{T_ * HD, D, HD},
                               tc::Layout{(long long)T_ * H, 1, H}};
  return (int)launch<T>(a, out, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (qkv and o share it; lse
// is float32).
extern "C" int flash_mha_packed_fwd(const void* qkv, void* o, void* lse,
                                    int B, int T, int H, int D, int causal,
                                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(qkv, o, lse, B, T, H, D, causal, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(qkv, o, lse, B, T, H, D, causal, s);
  if (dtype == 2) return run<__half>(qkv, o, lse, B, T, H, D, causal, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory a block of the kernel takes at head width D, for
// chip_smoke.py's resource report (dtype as above)
extern "C" int flash_mha_packed_smem_bytes(int D, int dtype) {
  return dtype == 0   ? fwd::smem_of<float>(D)
         : dtype == 1 ? fwd::smem_of<__nv_bfloat16>(D)
                      : fwd::smem_of<__half>(D);
}
