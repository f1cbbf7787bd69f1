// Phase 2 of the fit path: the L2 cotangent and loss prologue, the unpack of
// the packed residuals, and the hand-written replay adjoint of the bounce
// chain, one thread per pixel; then per-entity gradient sums.
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
// shared with adjoint_fused.cu).  The live set
// is one level's record, not the 305 planes of the all-levels form.  Levels
// at and after a miss, and pixels whose cotangent is 0, add exactly zero
// and are skipped.
//
// Gradients must not depend on the order in which blocks run, so no float
// atomics are used.  Each thread keeps, per level, its sphere and material
// cotangents with their ids; the block sums every (entity, field) column in
// a fixed order (a warp butterfly, then the warps in turn) and writes one
// row of a [num_blocks, 1 + 4 ns + 9 m + 3 nl] partial table (column 0 is
// the loss; adjoint_ops.cuh::block_column_sums).  adjoint_reduce_kernel then
// sums the rows in a fixed order.
//
// Bound: bytes.  A pixel reads 28 bytes (img, target, mask); only pixels
// with a nonzero cotangent read their ray and residuals up to the first
// miss and run the adjoint's few hundred FP32 operations per hit level
// (utils/opcount.py).  What this design spends instead is the column
// reduction: every block sums every column, whether or not its pixels
// touched that entity, so with 64 spheres and 66 materials (857 columns) it
// is most of the kernel's time (PERF.md).  Built, as every kernel, with
// -fmad=false (kernels/cuda_build.py), so that the replay rounds as the
// plain version does (adjoint_ops.cuh).  This first version aims to be
// right and deterministic; it is not tuned.
#include "adjoint_ops.cuh"

namespace rtfs {

template <bool WANT_TRANS>
__global__ void __launch_bounds__(kAdjThreads)
adjoint_packed_kernel(const float* __restrict__ tables, AdjParams ap,
                      const float* __restrict__ v,
                      const float* __restrict__ img,
                      const float* __restrict__ target,
                      const float* __restrict__ mask,
                      const float* __restrict__ pk,
                      float* __restrict__ partial, int num_pixels) {
  extern __shared__ float smem[];
  const Params& prm = ap.prm;
  const Scene s = load_scene(smem, tables, prm);
  const int p = blockIdx.x * blockDim.x + threadIdx.x;

  // ---- prologue: L2 cotangent and squared-error term ----
  float loss = 0.0f;
  float g[3] = {0.0f, 0.0f, 0.0f};
  int L = 0;  // hit levels of this pixel
  NodeConst cst[kMaxLevels];
  if (p < num_pixels) {
    const float mk = mask[p];
    for (int ch = 0; ch < 3; ++ch) {
      const float d_raw = img[3 * p + ch] - target[3 * p + ch];
      const float d = d_raw * mk;
      loss += d * d_raw;
      g[ch] = ap.g_scale * d;
    }
    if (g[0] != 0.0f || g[1] != 0.0f || g[2] != 0.0f) {
      // unpack (bi+1) + mid*bw_bi + lits*bw_bi*bw_mid (exact integers)
      for (; L <= prm.depth; ++L) {
        cst[L] = unpack_word(static_cast<unsigned>(__float2int_rn(
                                 pk[static_cast<size_t>(L) * num_pixels + p])),
                             ap.bw_bi, ap.bw_mid);
        if (cst[L].bik < 0) break;
      }
    }
  }

  GradRecs<kMaxLevels> gr;
  gr.init(prm.nl);
  if (L > 0)
    chain_adjoint<WANT_TRANS>(s, prm, cst, L, v[3 * p], v[3 * p + 1],
                              v[3 * p + 2], g, gr);
  block_column_sums(s, loss, gr, smem + table_floats(prm), ap.ncols,
                    partial + static_cast<size_t>(blockIdx.x) * ap.ncols);
}

// out[c] = sum over the rows of partial[:, c], in a fixed order: each
// thread sums a strided set of rows, then a tree over the block.
__global__ void __launch_bounds__(kAdjThreads)
adjoint_reduce_kernel(const float* __restrict__ partial, int num_blocks,
                      int ncols, float* __restrict__ out) {
  __shared__ float buf[kAdjThreads];
  const int c = blockIdx.x;
  float acc = 0.0f;
  for (int b = threadIdx.x; b < num_blocks; b += kAdjThreads)
    acc += partial[static_cast<size_t>(b) * ncols + c];
  buf[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kAdjThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) buf[threadIdx.x] += buf[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[c] = buf[0];
}

}  // namespace rtfs

// C entries (bound with ctypes from kernels/adjoint_fused.py).  `tables` is
// the flat misc | sph | tri | mat | light buffer; v, img, target [P,3], mask
// [P], pk [depth+1, P] f32; `partial` is [num_blocks, 1 + 4 ns + 9 m + 3 nl]
// with num_blocks = ceil(P / 256).  Each launches on `stream` and returns
// the launch's cudaError_t.
extern "C" int rtfs_adjoint_packed(const float* tables, int ns, int nt, int m,
                                   int nl, const float* v, const float* img,
                                   const float* target, const float* mask,
                                   const float* pk, int num_pixels,
                                   float eye_x, float eye_y, float eye_z,
                                   int depth, float atten, float g_scale,
                                   float bw_bi, float bw_mid, int want_trans,
                                   float* partial, int num_blocks,
                                   void* stream) {
  if (depth < 0 || depth >= rtfs::kMaxLevels || nl < 0 ||
      nl > rtfs::kMaxLights ||
      num_blocks * rtfs::kAdjThreads < num_pixels)
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
                                                mask, pk, partial,
                                                num_pixels);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtfs_adjoint_reduce(const float* partial, int num_blocks,
                                   int ncols, float* out, void* stream) {
  rtfs::adjoint_reduce_kernel<<<ncols, rtfs::kAdjThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      partial, num_blocks, ncols, out);
  return static_cast<int>(cudaGetLastError());
}
