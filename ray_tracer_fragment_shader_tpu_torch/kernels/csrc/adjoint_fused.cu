// The one-dispatch fit kernels: forward, cotangent and replay adjoint of one
// pixel in one thread, the residuals kept in the thread's own memory; then
// sparse per-entity gradient sums.
//
// Replaces two TPU kernels of the JAX package's kernels/adjoint_fused.py,
// each in its chain and its tree form (the template's TREE):
//   K6  _fused_fwd_bwd_kernel (:1031), launched by fused_loss_grads_pallas
//       (:1550): the L2 cotangent g = g_scale * mask * (img - target) and
//       the squared-error term formed from a target in the kernel
//       (EXTERNAL_G false);
//   K7  _recompute_bwd_kernel (:1123), launched by recompute_grads_pallas
//       (:1250): the cotangent planes g come from outside (EXTERNAL_G true),
//       the per-sample backward of the supersampled and adaptive fits.
// The chain adjoint is _adjoint_tile_body (:387-635), the tree adjoint
// _adjoint_tree_tile_body (:638-793); both are in adjoint_ops.cuh.
//
// Per pixel: the forward (tile_ops.cuh's chain_forward or tree_forward,
// the render kernels' own code, in its bf16_shading form with BF16) writes
// one record (bi, mid, lit bits) per hit level or preorder node into a
// per-thread array: the TPU kernel's unpacked VMEM scratch planes, and the
// residual forwards' fields (tile_ops.cuh::ResidualWriter).  No pack, so
// no limit on primitives, materials or lights but the adjoint's own
// (kMaxLights).  Nodes the forward does not visit hold bi = -1, a miss.
// Then the cotangent, then the adjoint, which replays in f32 on the records
// whatever the forward's precision.  A pixel whose cotangent is 0 adds
// exactly zero and runs no adjoint.
//
// K7 runs on the compacted list of the pixels whose g is nonzero
// (adjoint_packed.cu::rtfs_live_list, built on the device before it): a
// warp holds 32 live pixels, and no thread traces a pixel that adds
// nothing.  K6 runs on every pixel (its forward makes the cotangent).  Each
// block walks chunks of 256 (blockIdx.x, + gridDim.x, ...; at most
// kAdjGridCap blocks); a block with no chunk exits at once.
//
// Bound: operations.  A pixel reads 28 bytes (K6: ray, target, mask; K7:
// ray, cotangent) and writes none, against the forward's thousands of FP32
// operations (one closest-hit sweep plus one shadow sweep per light at
// every visited node) and the adjoint's few hundred per hit node.  What the
// design spends beyond that, and does about it:
// - thread memory.  The tree keeps a 6-byte record per preorder node
//   (adjoint_ops.cuh::TreeRec) and depth+1 adjoint frames; no gradient
//   records (each finished node goes to the block sums at once).  CUDA
//   reserves a kernel's local memory for every thread the card can hold,
//   so the tree form is instantiated for each depth cap of
//   kTreeAdjDepthCaps and a launch takes the smallest that holds the scene.
// - the gradient sums.  A warp adds only the (entity, field) columns its
//   lanes' nodes touch, step by step (adjoint_ops.cuh::BlockSums), where
//   every block once summed every column; the chain's and the tree's
//   reverse steps are warp-uniform for it.  Per-block partial rows in a
//   fixed order, then adjoint_packed.cu::adjoint_reduce_kernel over the
//   rows; no float atomics, two launches bit-identical.
// Built, as every kernel, with -fmad=false (kernels/cuda_build.py), forward
// included, so the topology the adjoint replays is the one the plain
// version's forward picks, and the one K2/K3/K5 pick, and the replay rounds
// as the plain version does.
#include <type_traits>

#include "adjoint_ops.cuh"

namespace rtfs {

// The tree depths the tree form is instantiated for, smallest first: 5,
// the reference's own depth (63 nodes a thread), 7, and 10, the tree
// forward's own limit (tile_ops.cuh::kTreeMaxDepth; kernels/adjoint_fused.py
// ::TREE_ADJOINT_DEPTH_CAPS).  Local memory a thread: 6 bytes a preorder
// node plus the frames (ptxas's figures per cap are in PERF.md), reserved
// for every resident thread only while the deepest cap launched so far is
// in use.
constexpr int kTreeAdjDepthCaps[] = {5, 7, 10};
constexpr int kTreeAdjMaxDepth = kTreeAdjDepthCaps[2];
static_assert(kTreeAdjMaxDepth == kTreeMaxDepth,
              "the tree adjoint holds every tree the tree forward holds");

// TREE_CAP: the deepest tree the per-thread arrays hold (tree form only).
// K7 (EXTERNAL_G) reads the live pixels' ids ids[0..*count) and their g;
// K6 every pixel's target and mask.
template <bool TREE, bool EXTERNAL_G, bool WANT_TRANS, bool BF16, int TREE_CAP>
__global__ void __launch_bounds__(kAdjThreads)
fused_adjoint_kernel(const float* __restrict__ tables, AdjParams ap,
                     const float* __restrict__ v,
                     const float* __restrict__ plane,  // K6 target, K7 g
                     const float* __restrict__ mask,   // K6 only
                     const int* __restrict__ ids,      // K7 only
                     const int* __restrict__ count,    // K7 only
                     float* __restrict__ partial, int num_pixels) {
  const int n = EXTERNAL_G ? *count : num_pixels;
  const int chunks = adjoint_chunks(n);
  if (static_cast<int>(blockIdx.x) >= chunks) return;
  extern __shared__ float smem[];
  const Params& prm = ap.prm;
  const Scene s = load_scene(smem, tables, prm);
  BlockSums sums(smem + table_floats(prm), prm, ap.ncols);
  using Rec = std::conditional_t<TREE, TreeRec, NodeConst>;
  constexpr int kNodes = TREE ? tree_nodes(TREE_CAP) : kMaxLevels;

  Rec recs[kNodes];
  float d_lp[kMaxLights][3];
  for (int li = 0; li < prm.nl; ++li)
    d_lp[li][0] = d_lp[li][1] = d_lp[li][2] = 0.0f;
  float loss = 0.0f;
  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const int q = chunk * kAdjThreads + threadIdx.x;
    float g[3] = {0.0f, 0.0f, 0.0f};
    float vx = 0.0f, vy = 0.0f, vz = 0.0f;
    int hits = 0;  // chain levels hit (the tree adjoint reads recs[] itself)
    bool live = false;
    if (q < n) {
      const int p = EXTERNAL_G ? ids[q] : q;
      if constexpr (EXTERNAL_G) {
        for (int ch = 0; ch < 3; ++ch) g[ch] = plane[3 * p + ch];
        live = g[0] != 0.0f || g[1] != 0.0f || g[2] != 0.0f;
      }
      if (!EXTERNAL_G || live) {
        // ---- forward, the residuals into recs[] ----
        vx = v[3 * p]; vy = v[3 * p + 1]; vz = v[3 * p + 2];
        float col[3] = {0.0f, 0.0f, 0.0f};
        auto sink = [&](int k, int bi, int mid, unsigned lit_bits) {
          if constexpr (TREE) {
            recs[k] = TreeRec{static_cast<short>(bi), static_cast<short>(mid),
                              static_cast<unsigned short>(lit_bits)};
          } else {
            recs[k] = NodeConst{bi, mid, lit_bits};
          }
        };
        if constexpr (TREE) {
          // a node the forward does not visit is a miss; the tree adjoint
          // reads only its bik
          const int nodes = tree_nodes(prm.depth);
          for (int k = 0; k < nodes; ++k) recs[k].bik = -1;
          tree_forward<WANT_TRANS, BF16>(s, prm, vx, vy, vz, col, sink);
        } else {
          hits =
              chain_forward<WANT_TRANS, BF16>(s, prm, vx, vy, vz, col, sink);
        }
        // ---- prologue: L2 cotangent and squared-error term ----
        if constexpr (!EXTERNAL_G) {
          const float mk = mask[p];
          for (int ch = 0; ch < 3; ++ch) {
            const float d_raw = col[ch] - plane[3 * p + ch];
            const float d = d_raw * mk;
            loss += d * d_raw;
            g[ch] = ap.g_scale * d;
          }
          live = g[0] != 0.0f || g[1] != 0.0f || g[2] != 0.0f;
        }
      }
    }
    // ---- adjoint, in f32 (every lane: its steps are warp-uniform) ----
    if constexpr (TREE) {
      tree_adjoint<WANT_TRANS, TREE_CAP>(s, prm, recs, live, vx, vy, vz, g,
                                         sums, d_lp);
    } else {
      chain_adjoint<WANT_TRANS>(s, prm, recs, live ? hits : 0, vx, vy, vz, g,
                                sums, d_lp);
    }
  }
  sums.finish(loss, d_lp,
              partial + static_cast<size_t>(blockIdx.x) * ap.ncols);
}

using FusedKernel = void (*)(const float*, AdjParams, const float*,
                             const float*, const float*, const int*,
                             const int*, float*, int);

template <bool TREE, bool EXTERNAL_G, int TREE_CAP>
FusedKernel pick_flags(bool want_trans, bool bf16) {
  if (bf16)
    return want_trans
               ? fused_adjoint_kernel<TREE, EXTERNAL_G, true, true, TREE_CAP>
               : fused_adjoint_kernel<TREE, EXTERNAL_G, false, true, TREE_CAP>;
  return want_trans
             ? fused_adjoint_kernel<TREE, EXTERNAL_G, true, false, TREE_CAP>
             : fused_adjoint_kernel<TREE, EXTERNAL_G, false, false, TREE_CAP>;
}

// The instantiation for the launch's flags: the chain, or the tree at the
// smallest depth cap that holds `depth`.
template <bool EXTERNAL_G>
FusedKernel pick_kernel(bool tree, bool want_trans, bool bf16, int depth) {
  if (!tree) return pick_flags<false, EXTERNAL_G, 0>(want_trans, bf16);
  if (depth <= kTreeAdjDepthCaps[0])
    return pick_flags<true, EXTERNAL_G, kTreeAdjDepthCaps[0]>(want_trans,
                                                              bf16);
  if (depth <= kTreeAdjDepthCaps[1])
    return pick_flags<true, EXTERNAL_G, kTreeAdjDepthCaps[1]>(want_trans,
                                                              bf16);
  return pick_flags<true, EXTERNAL_G, kTreeAdjDepthCaps[2]>(want_trans, bf16);
}

// Checks the launch's scalars, then launches the instantiation for them
// with num_blocks blocks (ceil(P / 256), at most kAdjGridCap) and the
// tables plus the block sums in dynamic shared memory.
template <bool EXTERNAL_G>
int launch_fused(bool tree, bool want_trans, bool bf16, const float* tables,
                 const AdjParams& ap, const float* v, const float* plane,
                 const float* mask, const int* ids, const int* count,
                 float* partial, int num_blocks, int num_pixels,
                 cudaStream_t stream) {
  const Params& prm = ap.prm;
  if (prm.depth < 0 ||
      (tree ? prm.depth > kTreeAdjMaxDepth : prm.depth >= kMaxLevels) ||
      prm.nl < 0 || prm.nl > kMaxLights ||
      (tree && (prm.nt + prm.ns > 32767 || prm.m > 32767)) ||
      num_blocks != adjoint_blocks(num_pixels) ||
      (EXTERNAL_G && (ids == nullptr || count == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const FusedKernel kernel =
      pick_kernel<EXTERNAL_G>(tree, want_trans, bf16, prm.depth);
  const size_t smem = adjoint_smem_bytes(ap);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<num_blocks, kAdjThreads, smem, stream>>>(
      tables, ap, v, plane, mask, ids, count, partial, num_pixels);
  return static_cast<int>(cudaGetLastError());
}

inline AdjParams adj_params(int ns, int nt, int m, int nl, int depth,
                            int white_id, int black_id, float small,
                            float atten, float eye_x, float eye_y,
                            float eye_z, float g_scale) {
  AdjParams ap;
  ap.prm = Params{ns, nt, m, nl, depth, white_id, black_id,
                  small, atten, eye_x, eye_y, eye_z};
  ap.g_scale = g_scale;
  ap.bw_bi = ap.bw_mid = 0;  // no pack
  ap.ncols = 1 + 4 * ns + 9 * m + 3 * nl;
  return ap;
}

}  // namespace rtfs

// C entries (bound with ctypes from kernels/adjoint_fused.py).  `tables` is
// the flat misc | sph | tri | mat | light buffer; v, target and g [P,3],
// mask [P] f32; `partial` is [num_blocks, 1 + 4 ns + 9 m + 3 nl] with
// num_blocks = min(ceil(P / 256), kAdjGridCap), to be summed by
// rtfs_adjoint_reduce.  `tree` selects the bounce tree (depth <=
// kTreeAdjMaxDepth) over the chain (depth <= 15), `bf16` the bf16_shading
// forward.  Each launches on `stream` and returns the launch's cudaError_t.

// K6: forward, L2 cotangent (2/denom = g_scale) and loss, adjoint.
extern "C" int rtfs_fused_adjoint(const float* tables, int ns, int nt, int m,
                                  int nl, const float* v, const float* target,
                                  const float* mask, int num_pixels,
                                  float eye_x, float eye_y, float eye_z,
                                  int depth, float small, float atten,
                                  int white_id, int black_id, int want_trans,
                                  int tree, int bf16, float g_scale,
                                  float* partial, int num_blocks,
                                  void* stream) {
  const rtfs::AdjParams ap =
      rtfs::adj_params(ns, nt, m, nl, depth, white_id, black_id, small, atten,
                       eye_x, eye_y, eye_z, g_scale);
  return rtfs::launch_fused<false>(tree, want_trans, bf16, tables, ap, v,
                                   target, mask, nullptr, nullptr, partial,
                                   num_blocks, num_pixels,
                                   static_cast<cudaStream_t>(stream));
}

// K7: forward re-trace and adjoint under the external cotangent g, over the
// live list ids[0..*count) of rtfs_live_list on g; column 0 of `partial`
// (the loss) is 0.
extern "C" int rtfs_recompute_adjoint(const float* tables, int ns, int nt,
                                      int m, int nl, const float* v,
                                      const float* g, const int* ids,
                                      const int* count, int num_pixels,
                                      float eye_x, float eye_y, float eye_z,
                                      int depth, float small, float atten,
                                      int white_id, int black_id,
                                      int want_trans, int tree, int bf16,
                                      float* partial, int num_blocks,
                                      void* stream) {
  const rtfs::AdjParams ap =
      rtfs::adj_params(ns, nt, m, nl, depth, white_id, black_id, small, atten,
                       eye_x, eye_y, eye_z, 0.0f);
  return rtfs::launch_fused<true>(tree, want_trans, bf16, tables, ap, v, g,
                                  nullptr, ids, count, partial, num_blocks,
                                  num_pixels,
                                  static_cast<cudaStream_t>(stream));
}
