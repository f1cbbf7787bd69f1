// Bounce-tree forward render kernel: the full binary tree of the reference's
// rayTraceRay recursion (MySdlApplication.cpp:1230-1248), for scenes with
// fractional transparency.  At every hit a transmitted child weighted by the
// transparency T and a reflected child weighted by the opacity 1-T are
// traced, down to `depth` levels: 2^(depth+1)-1 nodes in preorder.  With
// RESIDUALS it also writes the unpacked residual planes of every node.
//
// Replaces the JAX package's kernels/render_pallas.py::_render_tile_tree_kernel
// (its device code: _make_tile_ops and _tree_forward), in its plain form
// and, as the RESIDUALS instantiation, in its residual form
// (_call_kernel(tree=True, with_residuals=True), the forward of
// render_image_diff on fractional-transparency scenes).
//
// Bound: compute, as the chain kernel (render_chain.cu), times the number of
// live nodes; RESIDUALS adds (2+nl)*4 bytes per node of every pixel, live or
// not.  The recursion becomes a loop that descends into a node's
// transmitted child at once and keeps its reflected child on a per-thread
// stack (tile_ops.cuh::tree_forward), visiting the nodes in the same
// preorder (transmitted subtree before reflected), so the colour sums in
// the same order as the JAX kernel.  A node that misses, or a child whose
// weight gate is 0, adds exactly zero and is not visited; on a chain-exact
// scene the tree then costs what the chain does.  Its residuals are still
// written, with a dead lane's values (tile_ops.cuh::ResidualWriter: the
// visits come in increasing preorder index, so the gaps are filled as they
// appear).  Like the chain forward it is bound by latency (PERF.md §6):
// its lanes are 0.98 full on fractional_glass (opcount.
// tree_lane_efficiency), so what moved its time on an H100 was the
// stack's traffic (40-byte entries and no push or pop for a transmitted
// child: 7 % less time than the first design), while 4 blocks a SM (64
// registers) spilled and slowed the residual form 14 %.  Both forms have
// a BF16 instantiation, RenderConfig.bf16_shading (tile_ops.cuh's bf16
// shadow sweep and Phong blend; the C entries' `bf16`).
#include "tile_ops.cuh"

namespace rtfs {

template <bool WANT_TRANS, bool RESIDUALS, bool BF16>
__global__ void __launch_bounds__(256)
render_tree_kernel(const float* __restrict__ tables, Params prm,
                   const float* __restrict__ v, float* __restrict__ out,
                   int num_pixels) {
  extern __shared__ float smem[];
  const Scene s = load_scene(smem, tables, prm);
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= num_pixels) return;

  float col[3] = {0.0f, 0.0f, 0.0f};
  const int nodes = (2 << prm.depth) - 1;
  ResidualWriter res(prm, nodes, num_pixels, p);
  tree_forward<WANT_TRANS, BF16>(s, prm, v[3 * p], v[3 * p + 1], v[3 * p + 2],
                                 col,
                                 [&](int k, int bi, int mid,
                                     unsigned lit_bits) {
                                   if constexpr (RESIDUALS)
                                     res.hit(k, bi, mid, lit_bits);
                                 });
  if constexpr (RESIDUALS) res.fill_to(nodes);
  out[3 * p] = col[0];
  out[3 * p + 1] = col[1];
  out[3 * p + 2] = col[2];
}

// The instantiation for the launch's flags.
template <bool RESIDUALS>
RenderKernel pick_tree(int want_trans, int bf16) {
  if (bf16)
    return want_trans ? render_tree_kernel<true, RESIDUALS, true>
                      : render_tree_kernel<false, RESIDUALS, true>;
  return want_trans ? render_tree_kernel<true, RESIDUALS, false>
                    : render_tree_kernel<false, RESIDUALS, false>;
}

}  // namespace rtfs

// C entry, as rtfs_render_chain.  The caller guarantees
// depth <= kTreeMaxDepth; a deeper tree returns cudaErrorInvalidValue.
extern "C" int rtfs_render_tree(const float* tables, int ns, int nt, int m,
                                int nl, const float* v, float* out,
                                int num_pixels, float eye_x, float eye_y,
                                float eye_z, int depth, float small,
                                float atten, int white_id, int black_id,
                                int want_trans, int bf16, void* stream) {
  if (depth < 0 || depth > rtfs::kTreeMaxDepth)
    return static_cast<int>(cudaErrorInvalidValue);
  rtfs::Params prm{ns, nt, m, nl, depth, white_id, black_id,
                   small, atten, eye_x, eye_y, eye_z};
  return static_cast<int>(rtfs::launch_render(
      rtfs::pick_tree<false>(want_trans, bf16), tables, prm, v, out,
      num_pixels, static_cast<cudaStream_t>(stream)));
}

// The residual forward of the tree: as rtfs_render_tree, plus `res`
// [2+nl, 2^(depth+1)-1, num_pixels] f32, the unpacked planes bi | mid | lit
// of every preorder node.  At most kResidualMaxLights lights.
extern "C" int rtfs_render_tree_residuals(
    const float* tables, int ns, int nt, int m, int nl, const float* v,
    float* out, int num_pixels, float eye_x, float eye_y, float eye_z,
    int depth, float small, float atten, int white_id, int black_id,
    int want_trans, int bf16, float* res, void* stream) {
  if (depth < 0 || depth > rtfs::kTreeMaxDepth || nl < 0 ||
      nl > rtfs::kResidualMaxLights || res == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  rtfs::Params prm{ns, nt, m, nl, depth, white_id, black_id, small, atten,
                   eye_x, eye_y, eye_z, nullptr, 0.0f, 0.0f, res};
  return static_cast<int>(rtfs::launch_render(
      rtfs::pick_tree<true>(want_trans, bf16), tables, prm, v, out,
      num_pixels, static_cast<cudaStream_t>(stream)));
}

// Blocks of the tree kernel's instantiation (want_trans, form: 0 image,
// 1 residuals; bf16) one SM holds at once with `smem_bytes` of tables, into
// *blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int rtfs_tree_occupancy(int want_trans, int form, int bf16,
                                   int smem_bytes, int* blocks) {
  const rtfs::RenderKernel k = form == 0
                                   ? rtfs::pick_tree<false>(want_trans, bf16)
                                   : rtfs::pick_tree<true>(want_trans, bf16);
  const cudaError_t e = rtfs::kernel_occupancy(k, smem_bytes, blocks);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
