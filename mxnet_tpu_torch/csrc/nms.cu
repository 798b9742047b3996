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
// What bounds it on the H100: over the whole call the floor is the bytes
// (rows read once and written once) or ~20 flops for each (i, j) pair the
// data needs tested.  Only the greedy order is serial (whether row i
// suppresses depends on whether an earlier row suppressed it); the pairs'
// IoU tests are not.  A design that tests pairs inside the serial order
// pays a barrier round for every live row (~2,000 an image at SSD300's
// 8,732 rows).  The two designs below leave the order one round a 64-row
// block.  Which pairs the data needs differs with force_suppress: a class
// keeps most rows (force off), a cross-class test removes most (force on,
// ~98% of the live rows on clustered boxes), so each has its own kernel.
//
// Force off:
// 1. The suppression mask, fully parallel (nms_mask_kernel).  A CTA of
//    64 threads for each (image, row block I, chunk of kChunk = 8 column
//    blocks from J = I on; nb = ceil(A / 64) blocks) walks its column
//    blocks, staging each one's 64 rows in shared memory (two buffers,
//    the next block's rows in registers meanwhile, one barrier a block).
//    Chunks keep every CTA's walk short, so the first row blocks (137
//    column blocks each at SSD300's A) do not set the kernel's time.
//    Thread t owns word J of row i = 64 I + t: bit jj (j = 64 J + jj) is
//    set when j > i, both rows are live before NMS, the classes match and
//    IoU(j, i) >= thr.  Bits past A are zero.  A row block of dead rows
//    (score-sorted rows below the detection threshold sink to a dead
//    tail: about half of SSD300's) writes nothing, since the sweep never
//    reads a dead row's words, and a dead column block costs a zero word.
//    Each warp takes a word in two halves of 32 columns: a cheap stage
//    gives every pair a candidate bit from its class (~2.75 instructions
//    a pair, 1 in 20 passing at 20 classes), then the warp's candidates go
//    through one queue in shared memory and the 32 lanes take them two at
//    a time each through the full IoU, so the division runs on every lane
//    whatever each row's count.  The mask is a workspace of A * nb 64-bit
//    words an image, word-major (word J of row i at J * A + i: a block's
//    64 words are written, and read back, as one run), that the wrapper
//    allocates through torch on the rows' stream.
// 2. The sweep, serial only where greedy NMS is (nms_sweep_kernel).  One
//    CTA an image keeps the "removed" bits (nb words) in shared memory and
//    walks the row blocks in order, one barrier a block.  In round I warp
//    0 resolves block I against its diagonal words in registers, 32 rows
//    at a time (the lowest live row not removed survives and its diagonal
//    word, a shuffle, removes the later rows it suppresses; then the next
//    survivor), and ORs the survivors' words I + 1, loaded a round ahead
//    with the diagonal ones, into removed[I + 1]: the next round never
//    waits on memory.  Meanwhile the other warps OR block I - 1's
//    survivors' words I + 1 .. nb - 1 into "removed", a few loads in
//    flight a thread, threads splitting the survivors where few words are
//    left.  The removed bits are 32-bit halves: a shared-memory atomicOr
//    of 64 bits compiles to a compare-and-swap loop.  A row dead before
//    NMS is never a survivor and never marked.  Last, the rows are copied
//    out with cls = -1 where the removed bit is set.  nb rounds an image
//    (137 at A = 8,732) at most: they stop after the last block that
//    holds a live row.
// 3. Small A (A <= kFusedMaxRows, the toy detector's 192): one CTA of 12
//    warps an image computes its whole mask into shared memory, its words
//    spread over the warps, and sweeps it in the same launch
//    (nms_fused_kernel): one launch and no workspace.  The entry point
//    takes this path when it is given no workspace.
//
// Force on (nms_force_kernel, any A, no workspace): a mask would test
// every live pair although the sweep reads only the survivors' words, so
// this kernel tests only the pairs the greedy order needs: those of a
// survivor with a later row that no earlier survivor removed.  One CTA of
// 1,024 threads an image keeps "live" and "removed" bits in shared memory
// and walks the row blocks in order.  Round I: warp 0 resolves block I
// serially in registers (its rows' boxes loaded a round ahead): the
// lowest live row not removed survives, its box goes to every lane by
// shuffle, each lane tests its two rows and a ballot removes those it
// suppresses, then the next survivor; the survivors' boxes go to shared
// memory.  After a barrier every warp takes 32 later rows at a time
// (one 32-bit word of bits, so a word whose rows are all dead or removed
// is skipped by the whole warp, and a ballot writes it without an
// atomic): each row still standing tests the block's survivors until one
// suppresses it (its box read from the rows, where L2 holds them).  A
// round whose block has no survivor ends at the first barrier.
// Its time follows the pairs it tests (a standing row against each
// survivor until one removes it; most do not overlap, so the division is
// skipped) and the blocks, not A^2.
//
// The IoU is the Pallas body's, op for op, with round-to-nearest
// intrinsics: nvcc contracts a*b + c into an FMA by default, and one ulp
// decides a pair at the threshold.  Division is IEEE (__fdiv_rn).  The
// plain PyTorch version (unfused ops) equals the kernel bit for bit.
// The entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kBlock = 64;           // rows a block, bits a mask word
constexpr int kFusedMaxRows = 256;   // cuda_kernels.NMS_FUSED_MAX_ROWS
constexpr int kFusedThreads = 384;   // 12 warps: the tasks at A = 192
constexpr int kSweepThreads = 512;
constexpr int kForceThreads = 1024;
constexpr int kChunk = 8;            // column blocks a mask CTA walks
constexpr int kLoads = 8;            // mask loads in flight a thread
constexpr unsigned kFull = 0xffffffffu;
// the sweep's two survivor lists (a count each) and its live-block count
constexpr int kListInts = 2 * (kBlock + 1) + 1;

struct Row {
  float cls;
  float4 box;  // l, t, r, b
};

// A staged block of rows: boxes, classes (-1 past A) and areas.
struct Cols {
  float4 box[kBlock];
  float cls[kBlock];
  float area[kBlock];
};

// A warp's candidate queue for one half block (32 rows x 32 columns) and
// its result bits.
struct WarpScratch {
  unsigned short queue[32 * 32];
  unsigned bits[32];
};

__device__ __forceinline__ Row load_row(const float* in, int j, int A) {
  if (j >= A) return {-1.f, make_float4(0.f, 0.f, 0.f, 0.f)};
  const float* p = in + (long)j * 6;
  return {p[0], make_float4(p[2], p[3], p[4], p[5])};
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ __forceinline__ void put(Cols& c, int s, const Row& r) {
  c.box[s] = r.box;
  c.cls[s] = r.cls;
  c.area[s] = box_area(r.box);
}

// IoU(j, i) >= thr, op for op the Pallas body's arithmetic.  A pair that
// does not overlap (inter = +-0: w and h are never NaN) skips the
// division: its quotient would be +-0, which decides the pair as 0 does.
__device__ __forceinline__ bool suppresses(float4 bj, float area_j, float4 bi,
                                           float area_i, float thr) {
  const float w = fmaxf(__fsub_rn(fminf(bj.z, bi.z), fmaxf(bj.x, bi.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(bj.w, bi.w), fmaxf(bj.y, bi.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_j, area_i), inter);
  const float iou = uni > 0.f && inter != 0.f
                        ? __fdiv_rn(inter, fmaxf(uni, 1e-12f))
                        : 0.f;
  return iou >= thr;
}

// The bits of row r's word J (r: its place in row block I) that the half
// block from column h0 holds after r (j > i).
__device__ __forceinline__ unsigned eligible_bits(int I, int J, int r,
                                                  int h0) {
  const int shift = (J == I ? r + 1 : 0) - h0;
  return shift <= 0 ? kFull : shift >= 32 ? 0u : kFull << shift;
}

// One half of word J for the warp's 32 rows (rows rb + lane of the staged
// row block own) against columns h0 .. h0 + 31 of the staged column block
// c: bit k set when column h0 + k is eligible, of the row's class (so
// live, as the row is) and IoU(j, i) >= thr.  Every lane calls it.
// 1. The cheap stage: a candidate bit a column, from the class.
// 2. The candidates of all 32 lanes go to a queue (a prefix sum of their
//    counts) and the lanes take them two at a time each through the full
//    test, so the division runs on every lane whatever each row's count.
__device__ unsigned half_word(const Cols& c, int h0, const Cols& own, int rb,
                              bool live, unsigned eligible, float thr,
                              WarpScratch& ws) {
  const int lane = threadIdx.x & 31, r = rb + lane;
  unsigned cand = 0;
  if (live) {
    const float ci = own.cls[r];
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (c.cls[h0 + k] == ci) cand |= 1u << k;
    cand &= eligible;
  }
  const int n = __popc(cand);
  int end = n;  // inclusive prefix sum of the counts
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, end, o);
    if (lane >= o) end += v;
  }
  const int total = __shfl_sync(kFull, end, 31);
  for (int pos = end - n; cand; cand &= cand - 1)
    ws.queue[pos++] = (unsigned short)(lane << 5 | (__ffs(cand) - 1));
  ws.bits[lane] = 0u;
  __syncwarp();
  for (int q = lane; q < total; q += 64) {  // two candidates in flight
    const int e[2] = {ws.queue[q], ws.queue[q + 32 < total ? q + 32 : q]};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int rr = rb + (e[u] >> 5), k = e[u] & 31;
      if (suppresses(c.box[h0 + k], c.area[h0 + k], own.box[rr],
                     own.area[rr], thr))
        atomicOr(&ws.bits[e[u] >> 5], 1u << k);
    }
  }
  __syncwarp();
  return ws.bits[lane];
}

// Word J of row rb + lane of row block I (own) against column block c.
__device__ __forceinline__ u64 mask_word(const Cols& c, const Cols& own,
                                         int rb, int I, int J, float thr,
                                         WarpScratch& ws) {
  const int r = rb + (threadIdx.x & 31);
  const bool live = own.cls[r] >= 0.f;  // false for NaN, as the plain version
  const unsigned lo =
      half_word(c, 0, own, rb, live, eligible_bits(I, J, r, 0), thr, ws);
  const unsigned hi =
      half_word(c, 32, own, rb, live, eligible_bits(I, J, r, 32), thr, ws);
  return (u64)hi << 32 | lo;
}

// The mask is word-major: word J of row i at mask[J * A + i], so a block's
// words are written, and read back by the sweep, 64 rows in a row.
// 20 CTAs an SM (48 registers a thread): enough warps to hide the queue's
// shuffles and loads.
__global__ void __launch_bounds__(kBlock, 20)
    nms_mask_kernel(const float* __restrict__ rows, u64* __restrict__ mask,
                    int A, int nb, int ctas, float thr) {
  __shared__ Cols cols[2];
  __shared__ Cols own;
  __shared__ WarpScratch scratch[kBlock / 32];
  // CTA k of an image's ctas: chunk ch of row block I, column blocks
  // I + ch * kChunk on, kChunk of them (chunk-major: the chunks that hold
  // a diagonal block first)
  const long img = blockIdx.x / ctas;
  int I = blockIdx.x % ctas, ch = 0;
  while (I >= nb - ch * kChunk) I -= nb - ch * kChunk, ++ch;
  const int J0 = I + ch * kChunk, J1 = min(J0 + kChunk, nb);
  const int t = threadIdx.x, rb = t & ~31;
  const float* in = rows + img * A * 6;
  u64* m = mask + img * A * nb;
  const int i = I * kBlock + t;
  const Row me = load_row(in, i, A);
  put(own, t, me);
  // a block of dead rows: the sweep never reads their words (a dead row
  // is never a survivor), so none is written
  if (!__syncthreads_or(me.cls >= 0.f)) return;
  Row next = ch == 0 ? me : load_row(in, J0 * kBlock + t, A);
  for (int J = J0; J < J1; ++J) {
    Cols& c = cols[J & 1];
    put(c, t, next);
    const bool live = __syncthreads_or(next.cls >= 0.f);  // any column
    if (J + 1 < J1) next = load_row(in, (J + 1) * kBlock + t, A);
    const u64 word =
        live ? mask_word(c, own, rb, I, J, thr, scratch[t >> 5]) : 0ull;
    if (i < A) m[(long)J * A + i] = word;
  }
}

// Warp 0's view of row block I: lane's rows I*64 + lane and + 32, their
// classes (-1 past A), diagonal words (word I) and next words (word I + 1).
struct Ahead {
  u64 d0, d1, e0, e1;
  float c0, c1;
};

__device__ __forceinline__ Ahead load_ahead(const float* cls, int stride,
                                            const u64* mask, int A, int nb,
                                            int I, int lane) {
  const int r0 = I * kBlock + lane, r1 = r0 + 32;
  const bool next = I + 1 < nb;
  Ahead g;
  g.d0 = r0 < A ? mask[(long)I * A + r0] : 0ull;
  g.d1 = r1 < A ? mask[(long)I * A + r1] : 0ull;
  g.e0 = next && r0 < A ? mask[(long)(I + 1) * A + r0] : 0ull;
  g.e1 = next && r1 < A ? mask[(long)(I + 1) * A + r1] : 0ull;
  g.c0 = r0 < A ? cls[(long)r0 * stride] : -1.f;
  g.c1 = r1 < A ? cls[(long)r1 * stride] : -1.f;
  return g;
}

// ORs a 64-bit word into removed bits kept as 32-bit halves (the shared
// memory atomicOr of 64 bits is a compare-and-swap loop).
__device__ __forceinline__ void or_removed(unsigned* removed, int w, u64 v) {
  if ((unsigned)v) atomicOr(&removed[2 * w], (unsigned)v);
  if (v >> 32) atomicOr(&removed[2 * w + 1], (unsigned)(v >> 32));
}

// Copies an image's A rows from in to out, cls = -1 where row j's bit of
// removed (32-bit words) is set, by every thread of the block.
__device__ __forceinline__ void write_rows(const float* __restrict__ in,
                                           float* __restrict__ out, int A,
                                           const unsigned* removed) {
  const int n6 = A * 6;
  for (int k = threadIdx.x; k < n6; k += blockDim.x) {
    const int j = k / 6;
    float v = in[k];
    if (k == j * 6 && (removed[j >> 5] >> (j & 31) & 1u)) v = -1.f;
    out[k] = v;
  }
}

// The greedy order over one image's mask (word-major, A rows of nb words;
// row block I's words from I on written), by every thread of a block of at
// least 64.  cls: the rows' classes, stride floats apart; removed: 2 * (nb
// + 1) ints of shared memory (word w's halves at 2w, 2w + 1); lists:
// kListInts ints of shared memory.  Round I: warp 0 resolves block I
// (its removed word is complete), one half of 32 rows after the other,
// then ORs the survivors' words I + 1, which it loaded a round ahead, into
// removed[I + 1]; meanwhile the other warps OR block I - 1's survivors'
// words I + 1 .. nb - 1, from device memory, so their loads overlap the
// resolution.  One barrier a round.  Writes the image's rows to out with
// cls = -1 where suppressed.
__device__ void sweep(const float* __restrict__ in, float* __restrict__ out,
                      const float* cls, int stride, const u64* mask, int A,
                      int nb, unsigned* removed, int* lists) {
  const int tid = threadIdx.x, lane = tid & 31, nt = blockDim.x;
  const unsigned below = (1u << lane) - 1u;  // the lanes under this one
  int* live_blocks = lists + 2 * (kBlock + 1);
  for (int w = tid; w < 2 * (nb + 1); w += nt) removed[w] = 0u;
  if (tid == 0) *live_blocks = 0;
  __syncthreads();
  // the rounds end with the last block that holds a live row: after it
  // nothing is removed (a dead row is never marked)
  int last = 0;
  for (int r = tid; r < A; r += nt)
    if (cls[(long)r * stride] >= 0.f) last = r / kBlock + 1;
  if (last) atomicMax(live_blocks, last);
  Ahead g{};
  if (tid < 32) g = load_ahead(cls, stride, mask, A, nb, 0, lane);
  __syncthreads();
  const int nl = *live_blocks;
  for (int I = 0; I < nl; ++I) {
    if (tid < 32) {
      int* cur = lists + (I & 1) * (kBlock + 1);
      const Ahead next =
          I + 1 < nl ? load_ahead(cls, stride, mask, A, nb, I + 1, lane)
                     : Ahead{};
      unsigned rlo = removed[2 * I], rhi = removed[2 * I + 1];
      // rows 0-31: a survivor's word also removes rows of the upper half
      const unsigned d0lo = (unsigned)g.d0, d0hi = (unsigned)(g.d0 >> 32);
      unsigned todo = __ballot_sync(kFull, g.c0 >= 0.f) & ~rlo, klo = 0u;
      while (todo) {  // the same on every lane
        const int r = __ffs(todo) - 1;
        const unsigned lo = __shfl_sync(kFull, d0lo, r);
        rhi |= __shfl_sync(kFull, d0hi, r);
        rlo |= lo;
        klo |= 1u << r;
        todo &= ~lo & (todo - 1u);
      }
      // rows 32-63
      const unsigned d1hi = (unsigned)(g.d1 >> 32);
      todo = __ballot_sync(kFull, g.c1 >= 0.f) & ~rhi;
      unsigned khi = 0u;
      while (todo) {
        const int r = __ffs(todo) - 1;
        const unsigned hi = __shfl_sync(kFull, d1hi, r);
        rhi |= hi;
        khi |= 1u << r;
        todo &= ~hi & (todo - 1u);
      }
      const int nlo = __popc(klo);
      if (klo >> lane & 1u) cur[__popc(klo & below)] = I * kBlock + lane;
      if (khi >> lane & 1u)
        cur[nlo + __popc(khi & below)] = I * kBlock + 32 + lane;
      if (lane == 0) {
        removed[2 * I] = rlo;
        removed[2 * I + 1] = rhi;
        cur[kBlock] = nlo + __popc(khi);
      }
      or_removed(removed, I + 1, (klo >> lane & 1u ? g.e0 : 0ull)
                                     | (khi >> lane & 1u ? g.e1 : 0ull));
      g = next;
    } else if (I > 0) {
      const int* prev = lists + ((I - 1) & 1) * (kBlock + 1);
      const int n = prev[kBlock], L = nl - I - 1, np = nt - 32;
      if (n > 0 && L > 0) {
        // thread k ORs word I + 1 + k % L over survivors k / L, + G, ...
        const int G = L >= np ? 1 : np / L;
        for (int k = tid - 32; k < L * G; k += np) {
          const int w = I + 1 + k % L;
          const u64* word = mask + (long)w * A;
          u64 acc = 0ull;
          for (int s = k / L; s < n; s += G * kLoads) {
            u64 v[kLoads];
#pragma unroll
            for (int u = 0; u < kLoads; ++u) {
              const int q = s + u * G;
              v[u] = q < n ? word[prev[q]] : 0ull;
            }
#pragma unroll
            for (int u = 0; u < kLoads; ++u) acc |= v[u];
          }
          or_removed(removed, w, acc);
        }
      }
    }
    __syncthreads();
  }
  write_rows(in, out, A, removed);
}

__global__ void __launch_bounds__(kSweepThreads)
    nms_sweep_kernel(const float* __restrict__ rows, float* __restrict__ out,
                     const u64* __restrict__ mask, int A, int nb) {
  extern __shared__ unsigned removed[];  // 2 * (nb + 1)
  __shared__ int lists[kListInts];
  const float* in = rows + blockIdx.x * (long)A * 6;
  sweep(in, out + blockIdx.x * (long)A * 6, in, 6,
        mask + blockIdx.x * (long)A * nb, A, nb, removed, lists);
}

// One CTA of kFusedThreads an image, A <= kFusedMaxRows: the mask stays in
// shared memory.  Its words are tasks (32 rows of row block I, column block
// J >= I; nb (nb + 1) of them, 12 at A = 192) spread over the warps, so no
// warp takes three while another takes one.
__global__ void __launch_bounds__(kFusedThreads)
    nms_fused_kernel(const float* __restrict__ rows, float* __restrict__ out,
                     int A, int nb, float thr) {
  constexpr int kMaxBlocks = kFusedMaxRows / kBlock;
  __shared__ Cols cols[kMaxBlocks];
  __shared__ WarpScratch scratch[kFusedThreads / 32];
  __shared__ u64 mask[kMaxBlocks * kFusedMaxRows];
  __shared__ unsigned removed[2 * (kMaxBlocks + 1)];
  __shared__ int lists[kListInts];
  __shared__ float cls[kFusedMaxRows];
  const int t = threadIdx.x, warp = t >> 5;
  const float* in = rows + (long)blockIdx.x * A * 6;
  if (t < nb * kBlock) {
    const Row me = load_row(in, t, A);
    put(cols[t / kBlock], t % kBlock, me);
    cls[t] = me.cls;
  }
  __syncthreads();
  for (int task = warp; task < nb * (nb + 1); task += kFusedThreads / 32) {
    int I = 0, k = task;  // task k: row block I, half h, column block J
    while (k >= 2 * (nb - I)) k -= 2 * (nb - I++);
    const int h = k / (nb - I), J = I + k % (nb - I);
    const int i = I * kBlock + 32 * h + (t & 31);
    const u64 word =
        mask_word(cols[J], cols[I], 32 * h, I, J, thr, scratch[warp]);
    if (i < A) mask[J * A + i] = word;
  }
  __syncthreads();
  sweep(in, out + (long)blockIdx.x * A * 6, cls, 1, mask, A, nb, removed,
        lists);
}

__device__ __forceinline__ float4 shfl_box(float4 b, int src) {
  return make_float4(
      __shfl_sync(kFull, b.x, src), __shfl_sync(kFull, b.y, src),
      __shfl_sync(kFull, b.z, src), __shfl_sync(kFull, b.w, src));
}

// Greedy NMS under force_suppress, one CTA of kForceThreads an image, the
// survivors' pairs only.  Shared memory: live and removed bits (2 nb
// 32-bit words each: bit j of the rows' order), the round's survivors'
// boxes and areas, their count (two rounds' slots: a round without a
// survivor has one barrier, so the next round's count must not overwrite
// a count a slow warp has still to read).
__global__ void __launch_bounds__(kForceThreads)
    nms_force_kernel(const float* __restrict__ rows, float* __restrict__ out,
                     int A, int nb, float thr) {
  extern __shared__ unsigned bits[];  // live: 2 nb, then removed: 2 nb
  __shared__ float4 sbox[kBlock];
  __shared__ float sarea[kBlock];
  __shared__ int count[2];
  __shared__ int live_blocks;
  unsigned* live = bits;
  unsigned* removed = bits + 2 * nb;
  const int tid = threadIdx.x, lane = tid & 31, nt = blockDim.x;
  const float* in = rows + blockIdx.x * (long)A * 6;
  if (tid == 0) live_blocks = 0;
  __syncthreads();
  // whole warps over whole 32-bit words (nt and 64 are multiples of 32)
  for (int j = tid; j < nb * kBlock; j += nt) {
    const unsigned v = __ballot_sync(kFull, j < A && in[(long)j * 6] >= 0.f);
    if (lane == 0) {
      live[j >> 5] = v;
      removed[j >> 5] = 0u;
      if (v) atomicMax(&live_blocks, (j >> 6) + 1);
    }
  }
  Row r0{}, r1{};  // warp 0: block I's rows I*64 + lane and + 32
  if (tid < 32) {
    r0 = load_row(in, lane, A);
    r1 = load_row(in, lane + 32, A);
  }
  __syncthreads();
  // after the last block that holds a live row nothing is removed
  const int nl = live_blocks;
  for (int I = 0; I < nl; ++I) {
    if (tid < 32) {
      Row n0{}, n1{};
      if (I + 1 < nl) {
        n0 = load_row(in, (I + 1) * kBlock + lane, A);
        n1 = load_row(in, (I + 1) * kBlock + 32 + lane, A);
      }
      const float a0 = box_area(r0.box), a1 = box_area(r1.box);
      const unsigned lo = live[2 * I] & ~removed[2 * I];
      unsigned hi = live[2 * I + 1] & ~removed[2 * I + 1];
      unsigned klo = 0u, khi = 0u;
      int n = 0;
      // rows 0-31: a survivor also tests the standing rows 32-63
      for (unsigned todo = lo; todo;) {  // the same on every lane
        const int s = __ffs(todo) - 1;
        const float4 bs = shfl_box(r0.box, s);
        const float as = __shfl_sync(kFull, a0, s);
        const unsigned gone_lo = __ballot_sync(
            kFull, (todo >> lane & 1u) && lane > s &&
                       suppresses(r0.box, a0, bs, as, thr));
        const unsigned gone_hi = __ballot_sync(
            kFull, (hi >> lane & 1u) && suppresses(r1.box, a1, bs, as, thr));
        todo &= ~gone_lo & (todo - 1u);
        hi &= ~gone_hi;
        klo |= 1u << s;
        if (lane == 0) {
          sbox[n] = bs;
          sarea[n] = as;
        }
        ++n;
      }
      // rows 32-63
      for (unsigned todo = hi; todo;) {
        const int s = __ffs(todo) - 1;
        const float4 bs = shfl_box(r1.box, s);
        const float as = __shfl_sync(kFull, a1, s);
        const unsigned gone = __ballot_sync(
            kFull, (todo >> lane & 1u) && lane > s &&
                       suppresses(r1.box, a1, bs, as, thr));
        todo &= ~gone & (todo - 1u);
        khi |= 1u << s;
        if (lane == 0) {
          sbox[n] = bs;
          sarea[n] = as;
        }
        ++n;
      }
      if (lane == 0) {  // every live row of the block but the survivors
        removed[2 * I] = live[2 * I] & ~klo;
        removed[2 * I + 1] = live[2 * I + 1] & ~khi;
        count[I & 1] = n;
      }
      r0 = n0;
      r1 = n1;
    }
    __syncthreads();
    const int n = count[I & 1];
    if (n == 0) continue;  // the same on every thread
    // the later rows still standing against this block's survivors; a
    // warp owns word j >> 5 this round
    for (int j = (I + 1) * kBlock + tid; j < nb * kBlock; j += nt) {
      const int w = j >> 5;
      const unsigned standing = live[w] & ~removed[w];
      if (!standing) continue;  // the same on the warp's lanes
      bool gone = false;
      if (standing >> lane & 1u) {
        const float4 bj = load_row(in, j, A).box;
        const float aj = box_area(bj);
        for (int k = 0; k < n && !gone; ++k)
          gone = suppresses(bj, aj, sbox[k], sarea[k], thr);
      }
      const unsigned g = __ballot_sync(kFull, gone);
      if (lane == 0 && g) removed[w] |= g;
    }
    __syncthreads();
  }
  write_rows(in, out + blockIdx.x * (long)A * 6, A, removed);
}

cudaError_t launch_mask_sweep(const float* rows, float* out, u64* mask, int B,
                              int A, int nb, float thr, cudaStream_t stream) {
  int ctas = 0;  // an image's (row block, chunk) pairs
  for (int ch = 0; ch * kChunk < nb; ++ch) ctas += nb - ch * kChunk;
  nms_mask_kernel<<<B * ctas, kBlock, 0, stream>>>(rows, mask, A, nb, ctas,
                                                   thr);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nms_sweep_kernel<<<B, kSweepThreads, 2 * (nb + 1) * sizeof(unsigned),
                     stream>>>(rows, out, mask, A, nb);
  return cudaGetLastError();
}

}  // namespace

// rows, out: (B, A, 6) float32.  force: one launch of nms_force_kernel
// (mask unused).  Otherwise mask: B * A * ceil(A / 64) 64-bit words of
// device memory for the mask and the sweep, or null for the fused launch
// (A <= kFusedMaxRows).
extern "C" int nms(const void* rows, void* out, void* mask, int B, int A,
                   float thr, int force, void* stream) {
  const int nb = (A + kBlock - 1) / kBlock;
  const size_t bits = 4 * (size_t)nb * sizeof(unsigned);
  if (B < 1 || A < 1 || (long)A * 6 > 0x7fffffffL ||
      (!force && mask == nullptr && A > kFusedMaxRows) || bits > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const auto* r = static_cast<const float*>(rows);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (force) {
    nms_force_kernel<<<B, kForceThreads, bits, s>>>(r, o, A, nb, thr);
    return (int)cudaGetLastError();
  }
  if (mask == nullptr) {
    nms_fused_kernel<<<B, kFusedThreads, 0, s>>>(r, o, A, nb, thr);
    return (int)cudaGetLastError();
  }
  return (int)launch_mask_sweep(r, o, static_cast<u64*>(mask), B, A, nb, thr,
                                s);
}
