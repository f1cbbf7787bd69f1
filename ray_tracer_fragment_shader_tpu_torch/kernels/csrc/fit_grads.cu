// The split-mode backward (K8): the hand-written replay adjoint of the
// bounce chain from the unpacked residual planes, under a cotangent given
// from outside, on the compacted list of the pixels whose cotangent is
// nonzero; then sparse per-entity gradient sums.
//
// Replaces the JAX package's kernels/adjoint_fused.py::_bwd_tile_kernel
// (:814, on _adjoint_tile_body :387-635), launched by fit_grads_pallas
// (:1279, call :1354): the backward of fit_value_and_grad(mode="split"),
// after the residual forward (render_chain.cu, RESIDUALS) and the L2
// cotangent formed outside any kernel.
//
// Per live pixel: the cotangent g [3] is read; each level's pinned topology
// is built from the planes bi, mid [depth+1, P] and lit [nl, depth+1, P]
// (where K4 unpacks a word, adjoint_ops.cuh::unpack_word), up to the first
// miss, and the chain adjoint of K4 runs on it (adjoint_ops.cuh::
// chain_adjoint).  The planes carry no pack, so scenes whose packed word
// would overflow 2^24 take this path.
//
// The TPU grid accumulated the tables in place from one grid step to the
// next (_accumulate_grid, :796-811); GPU blocks run at the same time.  K8
// takes K4's launch whole (adjoint_packed.cu): the live list built on the
// device (rtfs_live_list on g), the blocks walking it in chunks of 256, the
// sparse sums of adjoint_ops.cuh::BlockSums into one row a block (column 0,
// the loss, is 0 here) and adjoint_reduce_kernel over the rows: no float
// atomics, bit-identical tables from launch to launch, and under K4's
// cotangent K4's tables bit for bit (the same live list, the same order).
//
// Bound: bytes.  A pixel reads its 12-byte cotangent; only pixels with a
// nonzero one read their ray and residual levels up to the first miss and
// run the adjoint's few hundred FP32 operations per hit level
// (utils/opcount.py::fit_grads_work).  The live list gives a warp 32 of
// those pixels.  Built, as every kernel, with -fmad=false
// (kernels/cuda_build.py).
#include "adjoint_ops.cuh"

namespace rtfs {

template <bool WANT_TRANS>
__global__ void __launch_bounds__(kAdjThreads)
fit_grads_kernel(const float* __restrict__ tables, AdjParams ap,
                 const float* __restrict__ v, const float* __restrict__ g_in,
                 const float* __restrict__ bi, const float* __restrict__ mid,
                 const float* __restrict__ lit, const int* __restrict__ ids,
                 const int* __restrict__ count, float* __restrict__ partial,
                 int num_pixels) {
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
  const size_t P = static_cast<size_t>(num_pixels);
  const size_t levels = static_cast<size_t>(prm.depth) + 1;
  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const int q = chunk * kAdjThreads + threadIdx.x;
    float g[3] = {0.0f, 0.0f, 0.0f};
    float vx = 0.0f, vy = 0.0f, vz = 0.0f;
    int L = 0;  // hit levels of this pixel
    NodeConst cst[kMaxLevels];
    if (q < n) {
      const int p = ids[q];
      for (int ch = 0; ch < 3; ++ch) g[ch] = g_in[3 * p + ch];
      for (; L <= prm.depth; ++L) {
        const size_t o = static_cast<size_t>(L) * P + p;
        // ids and flags are exact small integers in f32
        cst[L].bik = __float2int_rn(bi[o]);
        if (cst[L].bik < 0) break;
        cst[L].mid = __float2int_rn(mid[o]);
        unsigned lits = 0u;
        for (int li = 0; li < prm.nl; ++li)
          if (lit[li * levels * P + o] > 0.5f) lits |= 1u << li;
        cst[L].lits = lits;
      }
      vx = v[3 * p]; vy = v[3 * p + 1]; vz = v[3 * p + 2];
    }
    chain_adjoint<WANT_TRANS>(s, prm, cst, L, vx, vy, vz, g, sums, d_lp);
  }
  sums.finish(0.0f, d_lp,
              partial + static_cast<size_t>(blockIdx.x) * ap.ncols);
}

}  // namespace rtfs

// C entry (bound with ctypes from kernels/adjoint_fused.py).  `tables` is
// the flat misc | sph | tri | mat | light buffer; v and g [P,3], bi and mid
// [depth+1, P], lit [nl, depth+1, P] f32 (read only where nl > 0); ids and
// count the live list of rtfs_live_list on g; `partial` is [num_blocks,
// 1 + 4 ns + 9 m + 3 nl] with num_blocks = min(ceil(P / 256), kAdjGridCap),
// to be summed by rtfs_adjoint_reduce (its column 0 is 0).  Depth at most
// 15, at most 16 lights.  Launches on `stream` and returns the launch's
// cudaError_t.
extern "C" int rtfs_fit_grads(const float* tables, int ns, int nt, int m,
                              int nl, const float* v, const float* g,
                              const float* bi, const float* mid,
                              const float* lit, const int* ids,
                              const int* count, int num_pixels, float eye_x,
                              float eye_y, float eye_z, int depth,
                              float atten, int want_trans, float* partial,
                              int num_blocks, void* stream) {
  if (depth < 0 || depth >= rtfs::kMaxLevels || nl < 0 ||
      nl > rtfs::kMaxLights ||
      num_blocks != rtfs::adjoint_blocks(num_pixels) ||
      (nl > 0 && lit == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  rtfs::AdjParams ap;
  ap.prm = rtfs::Params{ns, nt, m, nl, depth, 0, 0, 0.0f, atten,
                        eye_x, eye_y, eye_z};
  ap.g_scale = 0.0f;
  ap.bw_bi = ap.bw_mid = 0;
  ap.ncols = 1 + 4 * ns + 9 * m + 3 * nl;
  auto kernel = want_trans ? rtfs::fit_grads_kernel<true>
                           : rtfs::fit_grads_kernel<false>;
  const size_t smem = rtfs::adjoint_smem_bytes(ap);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<num_blocks, rtfs::kAdjThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(tables, ap, v, g, bi, mid, lit,
                                                ids, count, partial,
                                                num_pixels);
  return static_cast<int>(cudaGetLastError());
}
