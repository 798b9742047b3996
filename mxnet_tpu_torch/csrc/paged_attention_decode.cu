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
// Design: the W = 1 launch of the verify kernels' template,
// paged::attend_kernel (paged_attention.cuh), at add = 0: one cluster of
// eight CTAs a (stream, head), the stream's pages split over the CTAs and
// their warps, each page's K and V slice copied once into a cp.async
// stage, the partial softmax states merged into rank 0 through
// distributed shared memory.  The block reads block_table[b, j] itself
// (this replaces the TPU's scalar prefetch) and walks only pages j <
// ceil(lengths[b] / KVB): the table's padding out to the cache bucket
// (page 0, the scratch page) is never touched.  q may be a strided view
// (the query third of the packed qkv): its batch stride is an argument,
// its head and lane strides are D and 1.  Head widths up to 128 in
// buckets of 32, 64, 96 and 128 lanes (paged::with_head_dim).
// Every entry point returns cudaGetLastError() after its launch.

#include "paged_attention.cuh"

namespace {

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, long qs, const void* kp, const void* vp,
                   const int* table, const int* lengths, void* out, int B,
                   int H, int D, int KVB, int MB, cudaStream_t stream) {
  const TQ* qq = static_cast<const TQ*>(q);
  TQ* o = static_cast<TQ*>(out);
  const paged::RawPages<TKV> pages{static_cast<const TKV*>(kp),
                                   static_cast<const TKV*>(vp)};
  return paged::with_head_dim(D, [&](auto dp, auto ragged) {
    (void)ragged;  // the kernel takes D at run time
    return paged::launch_attend<TQ, decltype(dp)::value, false>(
        qq, qs, 0, pages, table, lengths, 0, o, B, 1, H, D, KVB, MB, stream);
  });
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Supported
// pairs: (0, 0), (0, 1) and (0, 2) (an fp32 model over 16-bit pages),
// (1, 1) and (2, 2).  out has q's dtype.
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
  if (q_dtype == 0 && kv_dtype == 2)
    return (int)launch<float, __half>(q, q_batch_stride, k_pool, v_pool, t,
                                      n, out, B, H, D, KVB, MB, s);
  if (q_dtype == 2 && kv_dtype == 2)
    return (int)launch<__half, __half>(q, q_batch_stride, k_pool, v_pool, t,
                                       n, out, B, H, D, KVB, MB, s);
  return (int)cudaErrorInvalidValue;
}

// the dynamic shared memory of the instantiation for head-width bucket dp
// over kv_dtype pools (0 = float32, 1 = bfloat16, 2 = float16), and the
// CTAs a cluster
extern "C" int paged_attention_decode_smem_bytes(int dp, int kv_dtype) {
  return paged::smem_bytes(dp, kv_dtype == 0 ? 4 : 2, false);
}
extern "C" int paged_attention_decode_cluster_size() { return paged::NC; }
