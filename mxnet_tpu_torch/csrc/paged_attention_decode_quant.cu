// Paged decode attention over quantized K/V pages for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:paged_attention_decode_quant
// (the Pallas kernel _paged_decode_quant_kernel).  Same function as the
// decode kernel (paged_attention_decode.cu), over int8 or fp8-e4m3 pools
// (P, KVB, H, D) with (P, KVB, H) float32 scale pools, one scale per
// (slot, head): each K/V element is dequantized as float(code) * scale
// after it reaches shared memory, and the softmax and the P.V sum run in
// fp32.
//
// What bounds it on the H100: bytes.  A cached token-head costs D code
// bytes and one 4-byte scale for K and again for V, 2 * (D + 4) bytes, for
// 4 * D FLOP; the floor is those bytes over 3.35 TB/s, about 3.8x below
// the fp32 pages' (D = 64).
//
// Design: the decode kernel's (paged::attend_kernel at W = 1, add = 0)
// with the quantized page reader (paged::QuantPages): the codes stay one
// byte each through the cp.async stage (16-byte copies, 16 codes each, at
// D = 64), the scales ride along as 4-byte copies, so the arithmetic after
// the dequantization is the decode kernel's and the verify kernel's
// quantized rows equal it bit for bit.  Head widths up to 128, as the
// decode kernel.
// Every entry point returns cudaGetLastError() after its launch.

#include "paged_attention.cuh"

namespace {

template <typename TQ, typename TC>
cudaError_t launch(const void* q, long qs, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* table,
                   const int* lengths, void* out, int B, int H, int D,
                   int KVB, int MB, cudaStream_t stream) {
  const TQ* qq = static_cast<const TQ*>(q);
  TQ* o = static_cast<TQ*>(out);
  const paged::QuantPages<TC> pages{static_cast<const TC*>(kp),
                                    static_cast<const TC*>(vp), ks, vs};
  return paged::with_head_dim(D, [&](auto dp, auto ragged) {
    (void)ragged;  // the kernel takes D at run time
    return paged::launch_attend<TQ, decltype(dp)::value, false>(
        qq, qs, 0, pages, table, lengths, 0, o, B, 1, H, D, KVB, MB, stream);
  });
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16, 2 = float16.  kv_code: 2 = int8, 3 =
// fp8 e4m3
// (float8_e4m3fn).  Scales are float32 (P, KVB, H).  out has q's dtype.
extern "C" int paged_attention_decode_quant(
    const void* q, long q_batch_stride, const void* k_pool,
    const void* v_pool, const void* k_scale, const void* v_scale,
    const void* table, const void* lengths, void* out, int B, int H, int D,
    int KVB, int MB, int q_dtype, int kv_code, void* stream) {
  if (B < 1 || H < 1 || KVB < 1 || MB < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* n = static_cast<const int*>(lengths);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  if (q_dtype == 0 && kv_code == 2)
    return (int)launch<float, signed char>(q, q_batch_stride, k_pool, v_pool,
                                           ks, vs, t, n, out, B, H, D, KVB,
                                           MB, s);
  if (q_dtype == 0 && kv_code == 3)
    return (int)launch<float, unsigned char>(q, q_batch_stride, k_pool,
                                             v_pool, ks, vs, t, n, out, B, H,
                                             D, KVB, MB, s);
  if (q_dtype == 1 && kv_code == 2)
    return (int)launch<__nv_bfloat16, signed char>(
        q, q_batch_stride, k_pool, v_pool, ks, vs, t, n, out, B, H, D, KVB,
        MB, s);
  if (q_dtype == 1 && kv_code == 3)
    return (int)launch<__nv_bfloat16, unsigned char>(
        q, q_batch_stride, k_pool, v_pool, ks, vs, t, n, out, B, H, D, KVB,
        MB, s);
  if (q_dtype == 2 && kv_code == 2)
    return (int)launch<__half, signed char>(q, q_batch_stride, k_pool,
                                            v_pool, ks, vs, t, n, out, B, H,
                                            D, KVB, MB, s);
  if (q_dtype == 2 && kv_code == 3)
    return (int)launch<__half, unsigned char>(q, q_batch_stride, k_pool,
                                              v_pool, ks, vs, t, n, out, B,
                                              H, D, KVB, MB, s);
  return (int)cudaErrorInvalidValue;
}

// the dynamic shared memory of the instantiation for head-width bucket dp
// (int8 and fp8 codes alike), and the CTAs a cluster
extern "C" int paged_attention_decode_quant_smem_bytes(int dp) {
  return paged::smem_bytes(dp, 1, true);
}
extern "C" int paged_attention_decode_quant_cluster_size() {
  return paged::NC;
}
