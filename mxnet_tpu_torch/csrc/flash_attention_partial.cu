// Flash attention, un-normalized partial state, forward, for Hopper
// (sm_90a), on the tensor cores.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:flash_attention_partial (the
// Pallas kernel _flash_kernel behind blockwise_attention_partial: every hop
// of mxnet_tpu.sequence.ring_attention and the decode-time layout of
// ulysses_attention).  Same function: q (B, Tq, H, D), k and v (B, Tk, H, D),
// any head width D up to kMaxHeadDim, Tq and Tk free (tails masked, never
// padded), and a key offset koff = (absolute position of k[0]) - (absolute
// position of q[0]), and an optional per-row key limit kv_len (B,) int32
// in device memory (key j is seen by row b's queries only if j <
// kv_len[b], on top of the causal mask: JAX's lengths= mask) →
//   o (B, H, Tq, D) float32, UN-normalized: sum_j p_ij v_j,
//   m (B, H, Tq) float32, the row max of the scaled scores (natural units),
//   l (B, H, Tq) float32, sum_j p_ij,
// with p_ij = exp(q_i.k_j/sqrt(D) - m_i) over the visible keys: all of them,
// or under the causal mask those with j + koff <= i, and below kv_len[b]
// when given.  A row that sees no key
// comes out as m = -inf, l = 0, o = 0 exactly (the ring's merge tests
// isfinite(m)).  The outputs are float32 for bf16 and fp16 inputs too.
//
// Rounding, as the TPU kernel's: scores in the exp2 domain, accumulated
// in fp32; m is written back in natural units (times ln 2).  fp32: Q.K^T
// and P.V each as split TF32; bf16 and fp16: both on the type's tensor
// cores, p rounded to the input type before P.V (p.astype(v.dtype)); l is
// summed over fp32 p.
//
// Layout: q, k and v are addressed through their own (batch, head, row)
// element strides, lanes contiguous, so (B, H, T, D) views of the BTHD
// tensors need no transpose copy.  o, m and l are contiguous.
//
// What bounds it on the H100: the work.  A ring hop at (1, 12, 4096, 4096,
// 64) with nothing masked is ~5.2e10 FLOP against ~38 MB of traffic (fp32),
// far above the memory line: 0.312 ms at split TF32's 165 TFLOP/s, 0.052
// ms at bf16's and fp16's 989.
//
// Design: the body is fwd::attend (attention_fwd.cuh), the tensor-core
// forward of B1 and B5, with the key offset in its mask (row i sees key j
// when j <= min(i - koff, Tk - 1), 64-bit) and the Partial epilogue.  A
// causal block loads key tiles up to its last valid row's limit only, and
// one that sees no key at all (a positive koff past its rows, or kv_len[b]
// = 0) loads nothing and writes the empty state.  kv_len is read from
// device memory by each block (once), so a launch with the suffix
// prefill's start or a decode's lengths on the device records into a
// CUDA graph; a null kv_len is the unlimited kernel of before.
// Every entry point returns cudaGetLastError() after its launch.

#include "attention_fwd.cuh"

namespace {

template <typename T, int DP>
__global__ void __launch_bounds__(fwd::NT)
partial_fwd_kernel(fwd::Args a, float scale_log2, int vec16,
                   fwd::Partial out) {
  fwd::attend<T, DP>(a, scale_log2, vec16, out);
}

template <typename T>
cudaError_t launch(const fwd::Args& a, const fwd::Partial& out,
                   cudaStream_t s) {
  if (a.D <= 32)
    return fwd::launch_dp<T, 32, &partial_fwd_kernel<T, 32>>(a, out, s);
  if (a.D <= 64)
    return fwd::launch_dp<T, 64, &partial_fwd_kernel<T, 64>>(a, out, s);
  if (a.D <= 96)
    return fwd::launch_dp<T, 96, &partial_fwd_kernel<T, 96>>(a, out, s);
  return fwd::launch_dp<T, 128, &partial_fwd_kernel<T, 128>>(a, out, s);
}

}  // namespace

// strides: 9 element strides, (batch, head, row) of q, k and v in that
// order.  dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k and v share
// it); o (B, H, Tq, D), m and l (B, H, Tq) are float32 and contiguous.
// kv_len: (B,) int32 on the device, or null.
extern "C" int flash_attention_partial_fwd(
    const void* q, const void* k, const void* v, void* o, void* m, void* l,
    const long long* strides, int B, int H, int Tq, int Tk, int D,
    int causal, int kv_offset, const void* kv_len, int dtype,
    void* stream) {
  tc::Layout ls[3];
  for (int i = 0; i < 3; ++i)
    ls[i] = tc::Layout{strides[3 * i], strides[3 * i + 1],
                       strides[3 * i + 2]};
  const fwd::Args a{q, k, v, ls[0], ls[1], ls[2], B, H, Tq, Tk, D, causal,
                    kv_offset, static_cast<const int*>(kv_len)};
  if (fwd::bad_args(a)) return (int)cudaErrorInvalidValue;
  const fwd::Partial out{static_cast<float*>(o), static_cast<float*>(m),
                         static_cast<float*>(l), H, Tq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, out, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, out, s);
  if (dtype == 2) return (int)launch<__half>(a, out, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory a block of the kernel takes at head width D, for
// chip_smoke.py's resource report (dtype as above)
extern "C" int flash_attention_partial_smem_bytes(int D, int dtype) {
  return dtype == 0   ? fwd::smem_of<float>(D)
         : dtype == 1 ? fwd::smem_of<__nv_bfloat16>(D)
                      : fwd::smem_of<__half>(D);
}
