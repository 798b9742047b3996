// Greedy non-maximum suppression for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py:nms and its body _nms_kernel
// (grid=(B,), one image's (A, 6) rows in VMEM, A sequential rounds of one
// vector IoU test each).  Same function: rows (B, A, 6) float32
// [cls, score, l, t, r, b], sorted by score.  For i = 0 .. A-1 in order, a
// live row i (cls >= 0) suppresses every later live row j > i of its class
// (any class when force_suppress) with IoU(j, i) >= nms_threshold, by
// setting cls_j = -1.  Columns 1-5 pass through; the input is not written.
//
// What bounds it on the H100: the rounds are serial (round i reads the
// suppressions of every round before it).  Over the whole call the floor is
// the bytes (rows read once and written once) or ~20 flops per (i, j) pair
// the data needs tested, but each live round is one block-wide step behind
// a barrier in which the block scans all A - i later rows for live rows of
// row i's class, so the live-round count times the SM's issue time for that
// scan sets the time (~2.7 us a live round at A = 8732 on one SM).
//
// Design (the simple one):
// * One block per image (grid B); blocks never wait on each other.
// * The mutable class column and the four box coordinates are staged in
//   shared memory as separate arrays (structure of arrays): 5 * A * 4
//   bytes, 174,640 B at A = 8732 (SSD300's default boxes), so dynamic
//   shared memory above 48 KB.  An A whose five columns do not fit keeps
//   only the class column in shared memory and reads the boxes from the
//   input in device memory, where L2 holds them: up to ~58k rows on an
//   H100 (227 KB a block), far above SSD512's 24,564.  A larger A is
//   refused (cudaErrorInvalidValue).
// * Thread t owns rows j = t, t + blockDim, ... for the whole call.  One
//   __syncthreads per live round.  A round whose row i is dead is skipped by
//   the whole block: a dead row suppresses nothing, and cls_i is read after
//   the last barrier and written by no round since, so every thread takes
//   the same branch.
// * The IoU is the Pallas body's, op for op, with round-to-nearest
//   intrinsics: nvcc contracts a*b + c into an FMA by default, and one ulp
//   decides a pair at the threshold.  Division is IEEE (__fdiv_rn).  The
//   plain PyTorch version (unfused ops) equals the kernel bit for bit.
// The entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

// boxes_in_smem: the boxes staged beside the class column, else read from
// the input rows.
__global__ void nms_kernel(const float* __restrict__ rows, float* out, int A,
                           float thr, int force, int boxes_in_smem) {
  extern __shared__ float smem[];
  const long base = (long)blockIdx.x * A * 6;
  const float* in = rows + base;
  float* o = out + base;
  for (long k = threadIdx.x; k < (long)A * 6; k += blockDim.x) o[k] = in[k];
  float* cls = smem;
  // the boxes with their stride, and the distance between l, t, r and b
  const float* bx = boxes_in_smem ? smem + A : in + 2;
  const int bs = boxes_in_smem ? 1 : 6;
  const long plane = boxes_in_smem ? A : 1;
  for (int j = threadIdx.x; j < A; j += blockDim.x) {
    cls[j] = in[(long)j * 6];
    if (boxes_in_smem)
      for (int c = 0; c < 4; ++c)
        smem[(long)(c + 1) * A + j] = in[(long)j * 6 + 2 + c];
  }
  __syncthreads();

  for (int i = 0; i < A - 1; ++i) {
    const float ci = cls[i];
    if (ci < 0.f) continue;  // dead: the same shared value for every thread
    const float li = bx[(long)i * bs], ti = bx[(long)i * bs + plane];
    const float ri = bx[(long)i * bs + 2 * plane];
    const float bi = bx[(long)i * bs + 3 * plane];
    const float area_i = __fmul_rn(__fsub_rn(ri, li), __fsub_rn(bi, ti));
    // this thread's first row after i
    int j = (i + 1) / blockDim.x * blockDim.x + threadIdx.x;
    if (j <= i) j += blockDim.x;
    for (; j < A; j += blockDim.x) {
      const float cj = cls[j];
      if (cj < 0.f || (!force && cj != ci)) continue;
      const float* p = bx + (long)j * bs;
      const float lj = p[0], tj = p[plane];
      const float rj = p[2 * plane], bj = p[3 * plane];
      const float w = fmaxf(__fsub_rn(fminf(rj, ri), fmaxf(lj, li)), 0.f);
      const float h = fmaxf(__fsub_rn(fminf(bj, bi), fmaxf(tj, ti)), 0.f);
      const float inter = __fmul_rn(w, h);
      const float area_j = __fmul_rn(__fsub_rn(rj, lj), __fsub_rn(bj, tj));
      const float uni = __fsub_rn(__fadd_rn(area_j, area_i), inter);
      const float iou = uni > 0.f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.f;
      if (iou >= thr) cls[j] = -1.f;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < A; j += blockDim.x) o[(long)j * 6] = cls[j];
}

}  // namespace

extern "C" int nms(const void* rows, void* out, int B, int A, float thr,
                   int force, void* stream) {
  if (B < 1 || A < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t col = (size_t)A * sizeof(float);
  const int boxes_in_smem = 5 * col <= (size_t)optin;
  const size_t smem = boxes_in_smem ? 5 * col : col;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = A >= 1024 ? 1024 : (A + 31) / 32 * 32;
  nms_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<float*>(out), A, thr,
      force, boxes_in_smem);
  return (int)cudaGetLastError();
}
