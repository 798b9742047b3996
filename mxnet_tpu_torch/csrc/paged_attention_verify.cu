// Speculative-verify paged attention for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:paged_attention_verify (the
// Pallas kernel _paged_verify_kernel) and, over quantized pools, the lax
// function mxnet_tpu/ops/attention.py:paged_verify_attention_q, which has
// no Pallas kernel.  Same function: W = 1 + k queries per stream,
// q (B, W, H, D) at positions start[b] + w, against K/V pages
// (P, KVB, H, D) through the block table (B, MB) under the diagonal mask
// k_pos < start[b] + 1 + w; out (B, W, H, D).  Row w equals the decode
// kernel (quantized: the quantized decode kernel) at lengths =
// start + 1 + w, bit for bit, over the same pool bytes.
//
// What bounds it on the H100: bytes.  The pages a stream holds are read
// once (start + W tokens, 2 * D * element size per token-head, plus 2 * 4
// bytes of scales when quantized), for 4 * D FLOP per visible (row, token)
// pair; at W = 5 that is ~2.5 FLOP a byte in fp32, below the card's
// balance point.
//
// Design: paged::attend_kernel (paged_attention.cuh), the decode kernels'
// template, at add = 1: one cluster of eight CTAs a (stream, head)
// reads each live page's K and V slice once for the whole window, as the
// TPU kernel folds each page once into an (H, W, .) state, and folds it
// into the W rows' states, eight rows a pass (more loop over passes).
// The work partition depends on the page and token index alone, so row w
// meets exactly the tokens, groups and merge order of the decode step at
// start + 1 + w.  The raw page reader (paged_attention_verify) or the
// quantized one (paged_attention_verify_quant).  q is a strided view of
// the packed qkv (B, W, 3*H*D): batch and row strides are arguments, head
// and lane strides D and 1.  Padded batch rows (start = 0) read their
// table's first page and give finite values nobody uses.  Head widths up
// to 128, dispatched as the decode kernels (paged::with_head_dim).
// Every entry point returns cudaGetLastError() after its launch.

#include "paged_attention.cuh"

namespace {

template <typename TQ, typename Pages>
cudaError_t launch(const void* q, long qbs, long qrs, const Pages& pages,
                   const int* table, const int* start, void* out, int B,
                   int W, int H, int D, int KVB, int MB,
                   cudaStream_t stream) {
  const TQ* qq = static_cast<const TQ*>(q);
  TQ* o = static_cast<TQ*>(out);
  return paged::with_head_dim(D, [&](auto dp, auto ragged) {
    (void)ragged;  // the kernel takes D at run time
    return paged::launch_attend<TQ, decltype(dp)::value, true>(
        qq, qbs, qrs, pages, table, start, 1, o, B, W, H, D, KVB, MB,
        stream);
  });
}

template <typename TQ, typename TKV>
cudaError_t launch_raw(const void* q, long qbs, long qrs, const void* kp,
                       const void* vp, const int* table, const int* start,
                       void* out, int B, int W, int H, int D, int KVB,
                       int MB, cudaStream_t stream) {
  const paged::RawPages<TKV> pages{static_cast<const TKV*>(kp),
                                   static_cast<const TKV*>(vp)};
  return launch<TQ>(q, qbs, qrs, pages, table, start, out, B, W, H, D, KVB,
                    MB, stream);
}

template <typename TQ, typename TC>
cudaError_t launch_quant(const void* q, long qbs, long qrs, const void* kp,
                         const void* vp, const void* ks, const void* vs,
                         const int* table, const int* start, void* out,
                         int B, int W, int H, int D, int KVB, int MB,
                         cudaStream_t stream) {
  const paged::QuantPages<TC> pages{
      static_cast<const TC*>(kp), static_cast<const TC*>(vp),
      static_cast<const float*>(ks), static_cast<const float*>(vs)};
  return launch<TQ>(q, qbs, qrs, pages, table, start, out, B, W, H, D, KVB,
                    MB, stream);
}

bool bad_shape(int B, int W, int H, int D, int KVB, int MB) {
  return B < 1 || W < 1 || H < 1 || KVB < 1 || MB < 1 || H > 65535 ||
         W > 65535 || D < 1 || D > paged::kMaxHeadDim;
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16, 2 = float16; pairs (0, 0),
// (0, 1), (0, 2), (1, 1) and (2, 2), as the decode kernel.  out has q's
// dtype.
extern "C" int paged_attention_verify(const void* q, long q_batch_stride,
                                      long q_row_stride, const void* k_pool,
                                      const void* v_pool, const void* table,
                                      const void* start, void* out, int B,
                                      int W, int H, int D, int KVB, int MB,
                                      int q_dtype, int kv_dtype,
                                      void* stream) {
  if (bad_shape(B, W, H, D, KVB, MB)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* st = static_cast<const int*>(start);
  if (q_dtype == 0 && kv_dtype == 0)
    return (int)launch_raw<float, float>(q, q_batch_stride, q_row_stride,
                                         k_pool, v_pool, t, st, out, B, W, H,
                                         D, KVB, MB, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return (int)launch_raw<float, __nv_bfloat16>(
        q, q_batch_stride, q_row_stride, k_pool, v_pool, t, st, out, B, W, H,
        D, KVB, MB, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)launch_raw<__nv_bfloat16, __nv_bfloat16>(
        q, q_batch_stride, q_row_stride, k_pool, v_pool, t, st, out, B, W, H,
        D, KVB, MB, s);
  if (q_dtype == 0 && kv_dtype == 2)
    return (int)launch_raw<float, __half>(q, q_batch_stride, q_row_stride,
                                          k_pool, v_pool, t, st, out, B, W,
                                          H, D, KVB, MB, s);
  if (q_dtype == 2 && kv_dtype == 2)
    return (int)launch_raw<__half, __half>(q, q_batch_stride, q_row_stride,
                                           k_pool, v_pool, t, st, out, B, W,
                                           H, D, KVB, MB, s);
  return (int)cudaErrorInvalidValue;
}

// q_dtype: 0 = float32, 1 = bfloat16, 2 = float16; kv_code: 2 = int8, 3 =
// fp8 e4m3;
// scales float32 (P, KVB, H).
extern "C" int paged_attention_verify_quant(
    const void* q, long q_batch_stride, long q_row_stride,
    const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* table, const void* start, void* out,
    int B, int W, int H, int D, int KVB, int MB, int q_dtype, int kv_code,
    void* stream) {
  if (bad_shape(B, W, H, D, KVB, MB)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* st = static_cast<const int*>(start);
  if (q_dtype == 0 && kv_code == 2)
    return (int)launch_quant<float, signed char>(
        q, q_batch_stride, q_row_stride, k_pool, v_pool, k_scale, v_scale, t,
        st, out, B, W, H, D, KVB, MB, s);
  if (q_dtype == 0 && kv_code == 3)
    return (int)launch_quant<float, unsigned char>(
        q, q_batch_stride, q_row_stride, k_pool, v_pool, k_scale, v_scale, t,
        st, out, B, W, H, D, KVB, MB, s);
  if (q_dtype == 1 && kv_code == 2)
    return (int)launch_quant<__nv_bfloat16, signed char>(
        q, q_batch_stride, q_row_stride, k_pool, v_pool, k_scale, v_scale, t,
        st, out, B, W, H, D, KVB, MB, s);
  if (q_dtype == 1 && kv_code == 3)
    return (int)launch_quant<__nv_bfloat16, unsigned char>(
        q, q_batch_stride, q_row_stride, k_pool, v_pool, k_scale, v_scale, t,
        st, out, B, W, H, D, KVB, MB, s);
  if (q_dtype == 2 && kv_code == 2)
    return (int)launch_quant<__half, signed char>(
        q, q_batch_stride, q_row_stride, k_pool, v_pool, k_scale, v_scale, t,
        st, out, B, W, H, D, KVB, MB, s);
  if (q_dtype == 2 && kv_code == 3)
    return (int)launch_quant<__half, unsigned char>(
        q, q_batch_stride, q_row_stride, k_pool, v_pool, k_scale, v_scale, t,
        st, out, B, W, H, D, KVB, MB, s);
  return (int)cudaErrorInvalidValue;
}

// the dynamic shared memory of the instantiation for head-width bucket dp
// over kv_code pools (0 = float32, 1 = a 16-bit type: bfloat16 or float16,
// 2 = int8, 3 = fp8), and the CTAs a cluster
extern "C" int paged_attention_verify_smem_bytes(int dp, int kv_code) {
  return paged::smem_bytes(dp, kv_code == 0 ? 4 : kv_code == 1 ? 2 : 1,
                           kv_code >= 2);
}
extern "C" int paged_attention_verify_cluster_size() { return paged::NC; }
