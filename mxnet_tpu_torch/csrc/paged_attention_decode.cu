// Paged decode attention for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:paged_attention_decode (the
// Pallas kernel _paged_decode_kernel with its page fold _paged_fold_page).
// Same function: one query per stream, q (B, H, D) at position lengths-1,
// against K/V pages (P, KVB, H, D) gathered through the block table
// (B, MB) int32; pages at or past ceil(lengths/KVB) are never read, slots
// at or past lengths inside the last page are masked, the softmax runs in
// fp32, and a stream with lengths == 0 gets zeros, never NaN.
//
// What bounds it on the H100: bytes.  Each cached token's K and V row is
// read once and used for 2*D multiply-adds each, about 0.5 FLOP a byte in
// fp32, so the floor is the pages' bytes over 3.35 TB/s.
//
// Design (the body is paged::attend in paged_attention.cuh, shared with
// the quantized decode and the verify kernels):
// * One thread block per (stream, head), eight warps.  The block reads
//   block_table[b, j] itself (this replaces the TPU's scalar prefetch) and
//   walks only pages j < ceil(lengths[b] / KVB): the table's padding out to
//   the cache bucket (page 0, the scratch page) is never touched.
// * Warp w takes pages w, w+8, ...; eight tokens in flight per warp before
//   one online-softmax update; the warps' states merge at the end.
// * q may be a strided view (the query third of the packed qkv): its batch
//   stride is an argument, its head and lane strides are D and 1.
// * Head widths up to 128 in buckets of 32, 64, 96 and 128 lanes (DP/32
//   head lanes a thread; paged::with_head_dim): a width below its bucket
//   masks the lanes past D.
// Every entry point returns cudaGetLastError() after its launch.

#include "paged_attention.cuh"

namespace {

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, long qs, const void* kp, const void* vp,
                   const int* table, const int* lengths, void* out, int B,
                   int H, int D, int KVB, int MB, cudaStream_t stream) {
  const dim3 grid(B, H);
  const float scale = 1.f / sqrtf((float)D);
  const TQ* qq = static_cast<const TQ*>(q);
  TQ* o = static_cast<TQ*>(out);
  const paged::RawPages<TKV> pages{static_cast<const TKV*>(kp),
                                   static_cast<const TKV*>(vp)};
  return paged::with_head_dim(D, [&](auto dp, auto ragged) {
    paged::decode_kernel<TQ, decltype(dp)::value, decltype(ragged)::value>
        <<<grid, paged::NW * 32, 0, stream>>>(qq, qs, pages, table, lengths,
                                              o, H, D, KVB, MB, scale);
    return cudaGetLastError();
  });
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16.  Supported pairs: (0, 0),
// (0, 1) (fp32 model over bf16 pages) and (1, 1).  out has q's dtype.
extern "C" int paged_attention_decode(const void* q, long q_batch_stride,
                                      const void* k_pool,
                                      const void* v_pool, const void* table,
                                      const void* lengths, void* out, int B,
                                      int H, int D, int KVB, int MB,
                                      int q_dtype, int kv_dtype,
                                      void* stream) {
  if (B < 1 || H < 1 || KVB < 1 || MB < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* n = static_cast<const int*>(lengths);
  if (q_dtype == 0 && kv_dtype == 0)
    return (int)launch<float, float>(q, q_batch_stride, k_pool, v_pool, t, n,
                                     out, B, H, D, KVB, MB, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(q, q_batch_stride, k_pool,
                                             v_pool, t, n, out, B, H, D, KVB,
                                             MB, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        q, q_batch_stride, k_pool, v_pool, t, n, out, B, H, D, KVB, MB, s);
  return (int)cudaErrorInvalidValue;
}
