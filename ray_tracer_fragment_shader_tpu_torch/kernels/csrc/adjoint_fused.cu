// The one-dispatch fit kernels: forward, cotangent and replay adjoint of one
// pixel in one thread, the residuals kept in the thread's own memory; then
// per-entity gradient sums.
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
// (kMaxLights, the 32-bit lit word).  Nodes the forward does not visit hold
// bi = -1, a miss (only that field is written: 4 bytes a node, as the
// packed words took).  Then the
// cotangent, then the adjoint, which replays in f32 on the records whatever
// the forward's precision.  A pixel whose cotangent is 0 adds exactly zero
// and runs no adjoint; in K7 it runs no forward either.
//
// Bound: operations.  A pixel reads 28 bytes (K6: ray, target, mask; K7:
// ray, cotangent) and writes none, against the forward's thousands of FP32
// operations (one closest-hit sweep plus one shadow sweep per light at
// every visited node) and the adjoint's few hundred per hit node.  What the
// design spends beyond that: the per-thread arrays (the tree's node and
// gradient records sit in local memory, backed by L1 and L2; CUDA
// reserves that memory for every thread the card can hold, so the tree
// form is instantiated for each depth cap of kTreeAdjDepthCaps and the
// launch takes the smallest that holds the scene), and the column
// reduction of K4 (every block sums every column).  Gradients are
// deterministic as K4's: per-block partial rows in a fixed order, then
// adjoint_packed.cu::adjoint_reduce_kernel over the rows; no float atomics.
// Built, as every kernel, with -fmad=false (kernels/cuda_build.py), forward
// included, so the topology the adjoint replays is the one the plain
// version's forward picks, and the one K2/K3/K5 pick, and the replay rounds
// as the plain version does.  This first version aims
// to be right and deterministic; it is not tuned.
#include "adjoint_ops.cuh"

namespace rtfs {

// The tree depths the tree form is instantiated for, smallest first: 5,
// the reference's own depth (63 nodes a thread), and the deepest whose
// local memory stays under a few GB for an H100's 270,336 resident threads
// (kernels/adjoint_fused.py::TREE_ADJOINT_DEPTH_CAPS).  ptxas: 5312 B a
// thread at 5 (1.34 GiB reserved), 10,016 B at 6 (2.52 GiB); 7 would take
// 19,328 B (4.87 GiB), 8 37,856 B (9.5 GiB).
constexpr int kTreeAdjDepthCaps[] = {5, 6};
constexpr int kTreeAdjMaxDepth = kTreeAdjDepthCaps[1];

// TREE_CAP: the deepest tree the per-thread arrays hold (tree form only).
template <bool TREE, bool EXTERNAL_G, bool WANT_TRANS, bool BF16, int TREE_CAP>
__global__ void __launch_bounds__(kAdjThreads)
fused_adjoint_kernel(const float* __restrict__ tables, AdjParams ap,
                     const float* __restrict__ v,
                     const float* __restrict__ plane,  // K6 target, K7 g
                     const float* __restrict__ mask,   // K6 only
                     float* __restrict__ partial, int num_pixels) {
  extern __shared__ float smem[];
  const Params& prm = ap.prm;
  const Scene s = load_scene(smem, tables, prm);
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  constexpr int kNodes = TREE ? tree_nodes(TREE_CAP) : kMaxLevels;

  NodeConst recs[kNodes];
  float loss = 0.0f;
  float g[3] = {0.0f, 0.0f, 0.0f};
  float vx = 0.0f, vy = 0.0f, vz = 0.0f;
  int hits = 0;  // chain levels hit (the tree adjoint reads recs[] itself)
  bool live = false;
  if (p < num_pixels) {
    if constexpr (EXTERNAL_G) {
      for (int ch = 0; ch < 3; ++ch) g[ch] = plane[3 * p + ch];
      live = g[0] != 0.0f || g[1] != 0.0f || g[2] != 0.0f;
    }
    if (!EXTERNAL_G || live) {
      // ---- forward, the residuals into recs[] ----
      vx = v[3 * p]; vy = v[3 * p + 1]; vz = v[3 * p + 2];
      float col[3] = {0.0f, 0.0f, 0.0f};
      auto sink = [&](int k, int bi, int mid, unsigned lit_bits) {
        recs[k] = NodeConst{bi, mid, lit_bits};
      };
      if constexpr (TREE) {
        // a node the forward does not visit is a miss; the tree adjoint
        // reads only its bik
        const int nodes = tree_nodes(prm.depth);
        for (int k = 0; k < nodes; ++k) recs[k].bik = -1;
        tree_forward<WANT_TRANS, BF16>(s, prm, vx, vy, vz, col, sink);
      } else {
        hits = chain_forward<WANT_TRANS, BF16>(s, prm, vx, vy, vz, col, sink);
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

  // ---- adjoint, in f32 ----
  GradRecs<kNodes> gr;
  gr.init(prm.nl);
  if (live) {
    if constexpr (TREE) {
      tree_adjoint<WANT_TRANS, TREE_CAP>(s, prm, recs, vx, vy, vz, g, gr);
    } else {
      chain_adjoint<WANT_TRANS>(s, prm, recs, hits, vx, vy, vz, g, gr);
    }
  }
  block_column_sums(s, loss, gr, smem + table_floats(prm), ap.ncols,
                    partial + static_cast<size_t>(blockIdx.x) * ap.ncols);
}

using FusedKernel = void (*)(const float*, AdjParams, const float*,
                             const float*, const float*, float*, int);

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
  return pick_flags<true, EXTERNAL_G, kTreeAdjDepthCaps[1]>(want_trans, bf16);
}

// Checks the launch's scalars, then launches the instantiation for them with
// one thread per pixel and the tables plus the warps' column sums in dynamic
// shared memory.
template <bool EXTERNAL_G>
int launch_fused(bool tree, bool want_trans, bool bf16, const float* tables,
                 const AdjParams& ap, const float* v, const float* plane,
                 const float* mask, float* partial, int num_blocks,
                 int num_pixels, cudaStream_t stream) {
  const int depth = ap.prm.depth;
  if (depth < 0 || (tree ? depth > kTreeAdjMaxDepth : depth >= kMaxLevels) ||
      ap.prm.nl < 0 || ap.prm.nl > kMaxLights ||
      num_blocks * kAdjThreads < num_pixels)
    return static_cast<int>(cudaErrorInvalidValue);
  const FusedKernel kernel =
      pick_kernel<EXTERNAL_G>(tree, want_trans, bf16, depth);
  const size_t smem = adjoint_smem_bytes(ap);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<num_blocks, kAdjThreads, smem, stream>>>(tables, ap, v, plane,
                                                    mask, partial, num_pixels);
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
// num_blocks = ceil(P / 256), to be summed by rtfs_adjoint_reduce.  `tree`
// selects the bounce tree (depth <= kTreeAdjMaxDepth) over the chain (depth
// <= 15), `bf16` the bf16_shading forward.  Each launches on `stream` and
// returns the launch's cudaError_t.

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
                                   target, mask, partial, num_blocks,
                                   num_pixels,
                                   static_cast<cudaStream_t>(stream));
}

// K7: forward re-trace and adjoint under the external cotangent g; column
// 0 of `partial` (the loss) is 0.
extern "C" int rtfs_recompute_adjoint(const float* tables, int ns, int nt,
                                      int m, int nl, const float* v,
                                      const float* g, int num_pixels,
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
                                  nullptr, partial, num_blocks, num_pixels,
                                  static_cast<cudaStream_t>(stream));
}
