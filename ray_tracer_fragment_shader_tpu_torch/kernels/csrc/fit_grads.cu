// The split-mode backward (K8): the hand-written replay adjoint of the
// bounce chain from the unpacked residual planes, under a cotangent given
// from outside, one thread per pixel; then per-entity gradient sums.
//
// Replaces the JAX package's kernels/adjoint_fused.py::_bwd_tile_kernel
// (:814, on _adjoint_tile_body :387-635), launched by fit_grads_pallas
// (:1279, call :1354): the backward of fit_value_and_grad(mode="split"),
// after the residual forward (render_chain.cu, RESIDUALS) and the L2
// cotangent formed outside any kernel.
//
// Per pixel: the cotangent g [3] is read; a pixel whose g is 0 adds exactly
// zero and reads nothing else (as K7's EXTERNAL_G).  Otherwise each level's
// pinned topology is built from the planes bi, mid [depth+1, P] and lit
// [nl, depth+1, P] (where K4 unpacks a word, adjoint_ops.cuh::unpack_word),
// up to the first miss, and the chain adjoint of K4 runs on it
// (adjoint_ops.cuh::chain_adjoint).  The planes carry no pack, so scenes
// whose packed word would overflow 2^24 take this path.
//
// The TPU grid accumulated the tables in place from one grid step to the
// next (_accumulate_grid, :796-811); GPU blocks run at the same time, so
// each block writes one row of per-(entity, field) sums in a fixed order
// (adjoint_ops.cuh::block_column_sums; column 0, the loss, is 0 here) and
// adjoint_packed.cu::adjoint_reduce_kernel sums the rows in a fixed order:
// no float atomics, bit-identical tables from launch to launch.
//
// Bound: bytes.  A pixel reads its 12-byte cotangent; only pixels with a
// nonzero one read their ray and residual levels up to the first miss and
// run the adjoint's few hundred FP32 operations per hit level
// (utils/opcount.py::fit_grads_work).  What the design spends beyond that
// is K4's column reduction (every block sums every column).  Built, as
// every kernel, with -fmad=false (kernels/cuda_build.py): under K4's
// cotangent its tables equal K4's bit for bit.  This first version aims to
// be right and deterministic; it is not tuned.
#include "adjoint_ops.cuh"

namespace rtfs {

template <bool WANT_TRANS>
__global__ void __launch_bounds__(kAdjThreads)
fit_grads_kernel(const float* __restrict__ tables, AdjParams ap,
                 const float* __restrict__ v, const float* __restrict__ g_in,
                 const float* __restrict__ bi, const float* __restrict__ mid,
                 const float* __restrict__ lit, float* __restrict__ partial,
                 int num_pixels) {
  extern __shared__ float smem[];
  const Params& prm = ap.prm;
  const Scene s = load_scene(smem, tables, prm);
  const int p = blockIdx.x * blockDim.x + threadIdx.x;

  float g[3] = {0.0f, 0.0f, 0.0f};
  int L = 0;  // hit levels of this pixel
  NodeConst cst[kMaxLevels];
  if (p < num_pixels) {
    for (int ch = 0; ch < 3; ++ch) g[ch] = g_in[3 * p + ch];
    if (g[0] != 0.0f || g[1] != 0.0f || g[2] != 0.0f) {
      const size_t P = static_cast<size_t>(num_pixels);
      const size_t levels = static_cast<size_t>(prm.depth) + 1;
      for (; L <= prm.depth; ++L) {
        const size_t q = static_cast<size_t>(L) * P + p;
        // ids and flags are exact small integers in f32
        cst[L].bik = __float2int_rn(bi[q]);
        if (cst[L].bik < 0) break;
        cst[L].mid = __float2int_rn(mid[q]);
        unsigned lits = 0u;
        for (int li = 0; li < prm.nl; ++li)
          if (lit[li * levels * P + q] > 0.5f) lits |= 1u << li;
        cst[L].lits = lits;
      }
    }
  }

  GradRecs<kMaxLevels> gr;
  gr.init(prm.nl);
  if (L > 0)
    chain_adjoint<WANT_TRANS>(s, prm, cst, L, v[3 * p], v[3 * p + 1],
                              v[3 * p + 2], g, gr);
  block_column_sums(s, 0.0f, gr, smem + table_floats(prm), ap.ncols,
                    partial + static_cast<size_t>(blockIdx.x) * ap.ncols);
}

}  // namespace rtfs

// C entry (bound with ctypes from kernels/adjoint_fused.py).  `tables` is
// the flat misc | sph | tri | mat | light buffer; v and g [P,3], bi and mid
// [depth+1, P], lit [nl, depth+1, P] f32 (read only where nl > 0);
// `partial` is [num_blocks, 1 + 4 ns + 9 m + 3 nl] with num_blocks =
// ceil(P / 256), to be summed by rtfs_adjoint_reduce (its column 0 is 0).
// Depth at most 15, at most 16 lights.  Launches on `stream` and returns the
// launch's cudaError_t.
extern "C" int rtfs_fit_grads(const float* tables, int ns, int nt, int m,
                              int nl, const float* v, const float* g,
                              const float* bi, const float* mid,
                              const float* lit, int num_pixels, float eye_x,
                              float eye_y, float eye_z, int depth,
                              float atten, int want_trans, float* partial,
                              int num_blocks, void* stream) {
  if (depth < 0 || depth >= rtfs::kMaxLevels || nl < 0 ||
      nl > rtfs::kMaxLights || num_blocks * rtfs::kAdjThreads < num_pixels ||
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
                                                partial, num_pixels);
  return static_cast<int>(cudaGetLastError());
}
