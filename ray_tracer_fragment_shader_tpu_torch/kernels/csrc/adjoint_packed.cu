// Phase 2 of the fit path: the L2 cotangent and loss prologue, the unpack of
// the packed residuals, and the hand-written replay adjoint of the bounce
// chain, on the compacted list of the pixels it moves; then sparse
// per-entity gradient sums.  Also the two passes every compacted adjoint
// shares: the live list (rtfs_live_list) and the fixed-order sum of the
// blocks' rows (rtfs_adjoint_reduce).
//
// Replaces the JAX package's kernels/adjoint_fused.py::_bwd_packed_kernel
// (on _adjoint_tile_body, :387-635), launched by
// twophase_loss_grads_pallas.
//
// Per pixel: g = g_scale * mask * (img - target) and the squared-error term;
// pk unpacked per level; a primal pass that keeps each level's input ray
// (o, v) only; a reverse pass, level by level from the last hit down to 0,
// that re-derives the level's record from its (o, v) (the JAX kernel's
// ov_at route) and applies the node adjoint (adjoint_ops.cuh::chain_adjoint,
// shared with adjoint_fused.cu and fit_grads.cu).  Levels at and after a
// miss add exactly zero and are skipped.
//
// Bound: bytes.  A pixel reads 28 bytes (img, target, mask); only pixels
// with a nonzero cotangent (4.6 % at config 3 under the smoke's moved
// centres; PERF.md) read their ray and residuals up to the first miss and
// run the adjoint's few hundred FP32 operations per hit level
// (utils/opcount.py).  The design follows that:
// - a dense pass, bounded by bytes (live_mark_kernel): each pixel's
//   cotangent, the loss summed over every pixel in a fixed order, and per
//   warp a ballot of the live pixels; a scan over the blocks' counts
//   (live_scan_kernel) and a scatter (live_scatter_kernel) then write the
//   ordered list of live pixel ids and their count, all on the device (no
//   host synchronisation);
// - the adjoint maps its threads onto that list, so a warp holds 32 live
//   pixels, and walks it in chunks of 256 (blockIdx.x, + gridDim.x, ...; at
//   most kAdjGridCap blocks); a block past the count exits at once;
// - the gradient sums are sparse (adjoint_ops.cuh::BlockSums): a warp adds
//   only the (entity, field) columns its lanes touch, step by step, where
//   every block once summed every column (857 at config 5);
// - no float atomics: the blocks' rows are summed in a fixed order by
//   adjoint_reduce_kernel, which reads only the rows that hold live pixels;
//   two launches are bit-identical, and K8 (fit_grads.cu), on the same live
//   list, equals K4 bit for bit under K4's cotangent.
// Built, as every kernel, with -fmad=false (kernels/cuda_build.py), so that
// the replay rounds as the plain version does (adjoint_ops.cuh).
#include <algorithm>

#include "adjoint_ops.cuh"

namespace rtfs {

// ---- the live list -------------------------------------------------------

// Pass 1, one thread a pixel: whether its cotangent is nonzero (K4: formed
// from img, target and mask as the adjoint forms it; else read from g),
// per warp the ballot of those pixels, per block their count and (K4) the
// block's sum of the squared-error terms, in a fixed order
// (tile_ops.cuh::mark_live, which K6's records forwards run too).
__global__ void __launch_bounds__(kAdjThreads)
live_mark_kernel(const float* __restrict__ img,
                 const float* __restrict__ target,
                 const float* __restrict__ mask, const float* __restrict__ g,
                 float g_scale, int num_pixels, unsigned* __restrict__ ballots,
                 int* __restrict__ counts, float* __restrict__ loss_rows) {
  __shared__ BlockMarks marks;
  if (threadIdx.x == 0) marks.arrived = 0;
  __syncthreads();
  const int p = blockIdx.x * kAdjThreads + threadIdx.x;
  bool live = false;
  float loss = 0.0f;
  if (p < num_pixels) {
    if (img != nullptr) {
      const float im[3] = {img[3 * p], img[3 * p + 1], img[3 * p + 2]};
      l2_term(im, target, mask[p], g_scale, p, &loss, &live);
    } else {
      live = g[3 * p] != 0.0f || g[3 * p + 1] != 0.0f || g[3 * p + 2] != 0.0f;
    }
  }
  mark_live(marks, live, loss, ballots, counts, loss_rows);
}

constexpr int kScanThreads = 1024;

// Pass 2, one block: offsets[b] = the live pixels of the blocks before b,
// and *count = all of them.  Each thread sums a run of consecutive blocks,
// then a scan over the threads.
__global__ void __launch_bounds__(kScanThreads)
live_scan_kernel(const int* __restrict__ counts, int num_blocks,
                 int* __restrict__ offsets, int* __restrict__ count) {
  __shared__ int part[kScanThreads];
  const int per = (num_blocks + kScanThreads - 1) / kScanThreads;
  const int begin = threadIdx.x * per;
  const int end = min(begin + per, num_blocks);
  int sum = 0;
  for (int b = begin; b < end; ++b) sum += counts[b];
  part[threadIdx.x] = sum;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {  // inclusive scan
    const int x = threadIdx.x >= off ? part[threadIdx.x - off] : 0;
    __syncthreads();
    part[threadIdx.x] += x;
    __syncthreads();
  }
  int run = part[threadIdx.x] - sum;
  for (int b = begin; b < end; ++b) {
    offsets[b] = run;
    run += counts[b];
  }
  if (threadIdx.x == kScanThreads - 1) *count = part[kScanThreads - 1];
}

// Pass 3, one thread a pixel: each live pixel writes its id at its place in
// pixel order.
__global__ void __launch_bounds__(kAdjThreads)
live_scatter_kernel(const unsigned* __restrict__ ballots,
                    const int* __restrict__ offsets, int num_pixels,
                    int* __restrict__ ids) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned* wb = ballots + blockIdx.x * kAdjWarps;
  const unsigned word = wb[warp];
  if (!((word >> lane) & 1u)) return;
  int pos = offsets[blockIdx.x] + __popc(word & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) pos += __popc(wb[w]);
  ids[pos] = blockIdx.x * kAdjThreads + threadIdx.x;
}

// ---- K4 ------------------------------------------------------------------

template <bool WANT_TRANS>
__global__ void __launch_bounds__(kAdjThreads)
adjoint_packed_kernel(const float* __restrict__ tables, AdjParams ap,
                      const float* __restrict__ v,
                      const float* __restrict__ img,
                      const float* __restrict__ target,
                      const float* __restrict__ mask,
                      const float* __restrict__ pk,
                      const int* __restrict__ ids,
                      const int* __restrict__ count,
                      float* __restrict__ partial, int num_pixels) {
  const int n = *count;
  const int chunks = adjoint_chunks(n);
  if (static_cast<int>(blockIdx.x) >= chunks) return;
  extern __shared__ float smem[];
  const Params& prm = ap.prm;
  const Scene s = load_scene(smem, tables, prm);
  BlockSums sums(smem + table_floats(prm), prm, ap.ncols);
  float d_lp[kMaxLights][3];
  for (int li = 0; li < prm.nl; ++li)
    d_lp[li][0] = d_lp[li][1] = d_lp[li][2] = 0.0f;
  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const int q = chunk * kAdjThreads + threadIdx.x;
    float g[3] = {0.0f, 0.0f, 0.0f};
    float vx = 0.0f, vy = 0.0f, vz = 0.0f;
    int L = 0;  // hit levels of this pixel
    NodeConst cst[kMaxLevels];
    if (q < n) {
      // the cotangent, as the live pass formed it
      const int p = ids[q];
      const float mk = mask[p];
      for (int ch = 0; ch < 3; ++ch)
        g[ch] = ap.g_scale * ((img[3 * p + ch] - target[3 * p + ch]) * mk);
      // unpack (bi+1) + mid*bw_bi + lits*bw_bi*bw_mid (exact integers)
      for (; L <= prm.depth; ++L) {
        cst[L] = unpack_word(static_cast<unsigned>(__float2int_rn(
                                 pk[static_cast<size_t>(L) * num_pixels + p])),
                             ap.bw_bi, ap.bw_mid);
        if (cst[L].bik < 0) break;
      }
      vx = v[3 * p]; vy = v[3 * p + 1]; vz = v[3 * p + 2];
    }
    chain_adjoint<WANT_TRANS>(s, prm, cst, L, vx, vy, vz, g, sums, d_lp);
  }
  sums.finish(0.0f, d_lp,
              partial + static_cast<size_t>(blockIdx.x) * ap.ncols);
}

// The gradient tables from the blocks' rows: out is [loss | sphd (ns x 8) |
// matd (m x 16) | lightd (max(nl, 1) x 8)], the wrapper's table layouts
// (kernels/adjoint_fused.py: centre and radius, then 4 zeros; ambient,
// diffuse, specular, then 7 zeros; position, then 5 zeros), so the wrapper
// returns views of it.  Block i fills out[i]: the sum over the rows of
// partial [num_rows, 1 + 4 ns + 9 m + 3 nl] that hold live pixels
// (min(num_rows, chunks of *count), or all num_rows where count is null)
// of the matching column, in a fixed order (each thread a strided set of
// rows, then a tree over the block); 0 in a padding column.  With
// loss_rows, out[0] is their sum instead.
__global__ void __launch_bounds__(kAdjThreads)
adjoint_reduce_kernel(const float* __restrict__ partial, int num_rows,
                      int ns, int m, int nl, const int* __restrict__ count,
                      const float* __restrict__ loss_rows, int num_loss_rows,
                      float* __restrict__ out) {
  __shared__ float buf[kAdjThreads];
  const int i = blockIdx.x;
  const int ncols = 1 + 4 * ns + 9 * m + 3 * nl;
  int c = -1;  // the partial column of out[i], -1 for padding
  if (i == 0) {
    c = 0;
  } else if (i < 1 + 8 * ns) {
    const int r = (i - 1) / 8, k = (i - 1) % 8;
    if (k < 4) c = 1 + 4 * r + k;
  } else if (i < 1 + 8 * ns + 16 * m) {
    const int r = (i - 1 - 8 * ns) / 16, k = (i - 1 - 8 * ns) % 16;
    if (k < 9) c = 1 + 4 * ns + 9 * r + k;
  } else {
    const int r = (i - 1 - 8 * ns - 16 * m) / 8;
    const int k = (i - 1 - 8 * ns - 16 * m) % 8;
    if (r < nl && k < 3) c = 1 + 4 * ns + 9 * m + 3 * r + k;
  }
  if (c < 0) {
    if (threadIdx.x == 0) out[i] = 0.0f;
    return;
  }
  float acc = 0.0f;
  if (c == 0 && loss_rows != nullptr) {
    for (int b = threadIdx.x; b < num_loss_rows; b += kAdjThreads)
      acc += loss_rows[b];
  } else {
    const int rows =
        count != nullptr ? min(num_rows, adjoint_chunks(*count)) : num_rows;
    for (int b = threadIdx.x; b < rows; b += kAdjThreads)
      acc += partial[static_cast<size_t>(b) * ncols + c];
  }
  buf[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kAdjThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) buf[threadIdx.x] += buf[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[i] = buf[0];
}

}  // namespace rtfs

// C entries (bound with ctypes from kernels/adjoint_fused.py).  Each
// launches on `stream` and returns the launch's cudaError_t.

// The live list's passes 2 and 3 on the marks (ballots [ceil(P/256) * 8],
// counts [ceil(P/256)], at least one block's) of num_pixels pixels:
// offsets [ceil(P/256)] (scratch), ids [P] (the first *count hold the live
// pixels' ids in increasing order) and count [1].  K6 runs them after its
// records forward, which marks the blocks.
extern "C" int rtfs_live_ids(const unsigned* ballots, const int* counts,
                             int num_pixels, int* offsets, int* ids,
                             int* count, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = std::max(rtfs::adjoint_chunks(num_pixels), 1);
  rtfs::live_scan_kernel<<<1, rtfs::kScanThreads, 0, st>>>(counts, blocks,
                                                           offsets, count);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rtfs::live_scatter_kernel<<<blocks, rtfs::kAdjThreads, 0, st>>>(
      ballots, offsets, num_pixels, ids);
  return static_cast<int>(cudaGetLastError());
}

// The live list of num_pixels pixels: where img is given (K4), the pixels
// whose g_scale * mask * (img - target) [P,3] is nonzero, and loss_rows
// [ceil(P/256)] the blocks' squared-error sums; else those whose g [P,3]
// is nonzero (loss_rows unused).  Scratch: ballots [ceil(P/256) * 8],
// counts and offsets [ceil(P/256)].  Out: ids [P] (the first *count hold
// the live pixels' ids in increasing order) and count [1].
extern "C" int rtfs_live_list(const float* img, const float* target,
                              const float* mask, const float* g,
                              float g_scale, int num_pixels,
                              unsigned* ballots, int* counts, int* offsets,
                              float* loss_rows, int* ids, int* count,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = std::max(rtfs::adjoint_chunks(num_pixels), 1);
  if (num_pixels < 0 || (img == nullptr && g == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  rtfs::live_mark_kernel<<<blocks, rtfs::kAdjThreads, 0, st>>>(
      img, target, mask, g, g_scale, num_pixels, ballots, counts,
      img != nullptr ? loss_rows : nullptr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return rtfs_live_ids(ballots, counts, num_pixels, offsets, ids, count,
                       stream);
}

// K4 over the live list of rtfs_live_list(img, target, mask): `tables` is
// the flat misc | sph | tri | mat | light buffer; v, img, target [P,3],
// mask [P], pk [depth+1, P] f32; `partial` is [num_blocks, 1 + 4 ns + 9 m +
// 3 nl] with num_blocks = min(ceil(P / 256), kAdjGridCap), its column 0
// (the loss) 0: rtfs_adjoint_reduce takes the loss from the live list's
// loss_rows.
extern "C" int rtfs_adjoint_packed(const float* tables, int ns, int nt, int m,
                                   int nl, const float* v, const float* img,
                                   const float* target, const float* mask,
                                   const float* pk, const int* ids,
                                   const int* count, int num_pixels,
                                   float eye_x, float eye_y, float eye_z,
                                   int depth, float atten, float g_scale,
                                   float bw_bi, float bw_mid, int want_trans,
                                   float* partial, int num_blocks,
                                   void* stream) {
  if (depth < 0 || depth >= rtfs::kMaxLevels || nl < 0 ||
      nl > rtfs::kMaxLights ||
      num_blocks != rtfs::adjoint_blocks(num_pixels))
    return static_cast<int>(cudaErrorInvalidValue);
  rtfs::AdjParams ap;
  ap.prm = rtfs::Params{ns, nt, m, nl, depth, 0, 0, 0.0f, atten,
                        eye_x, eye_y, eye_z};
  ap.g_scale = g_scale;
  ap.bw_bi = static_cast<int>(bw_bi);
  ap.bw_mid = static_cast<int>(bw_mid);
  ap.ncols = 1 + 4 * ns + 9 * m + 3 * nl;
  auto kernel = want_trans ? rtfs::adjoint_packed_kernel<true>
                           : rtfs::adjoint_packed_kernel<false>;
  const size_t smem = rtfs::adjoint_smem_bytes(ap);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<num_blocks, rtfs::kAdjThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(tables, ap, v, img, target,
                                                mask, pk, ids, count, partial,
                                                num_pixels);
  return static_cast<int>(cudaGetLastError());
}

// out [1 + 8 ns + 16 m + 8 max(nl, 1)] = the gradient tables (loss, sphd,
// matd, lightd) summed from partial [num_rows, 1 + 4 ns + 9 m + 3 nl]: of
// its rows that hold live pixels where count (rtfs_live_list's) is given,
// else of all; out[0] from loss_rows [num_loss_rows] where they are given.
extern "C" int rtfs_adjoint_reduce(const float* partial, int num_rows, int ns,
                                   int m, int nl, const int* count,
                                   const float* loss_rows, int num_loss_rows,
                                   float* out, void* stream) {
  const int n_out = 1 + 8 * ns + 16 * m + 8 * (nl > 1 ? nl : 1);
  rtfs::adjoint_reduce_kernel<<<n_out, rtfs::kAdjThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      partial, num_rows, ns, m, nl, count, loss_rows, num_loss_rows, out);
  return static_cast<int>(cudaGetLastError());
}
