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
// the render kernels' own code) writes one packed word per hit level or
// preorder node, (bi+1) + mid*bw_bi + lits*bw_bi*bw_mid, into a per-thread
// array: the TPU kernel's VMEM scratch planes.  Nodes the forward does not
// visit hold the dead-lane word (bi+1 = 0, mid = 0, every lit bit).  Then
// the cotangent, then the adjoint, reading the array in place of K4's pk.
// A pixel whose cotangent is 0 adds exactly zero and runs no adjoint; in
// K7 it runs no forward either.
//
// Bound: operations.  A pixel reads 28 bytes (K6: ray, target, mask; K7:
// ray, cotangent) and writes none, against the forward's thousands of FP32
// operations (one closest-hit sweep plus one shadow sweep per light at
// every visited node) and the adjoint's few hundred per hit node.  What the
// design spends beyond that: the per-thread arrays (the tree's 63 words and
// records sit in local memory, backed by L1 and L2), and the column
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

template <bool TREE, bool EXTERNAL_G, bool WANT_TRANS>
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
  constexpr int kWords = TREE ? kTreeAdjMaxNodes : kMaxLevels;

  unsigned words[kWords];
  float loss = 0.0f;
  float g[3] = {0.0f, 0.0f, 0.0f};
  float vx = 0.0f, vy = 0.0f, vz = 0.0f;
  int hits = 0;  // chain levels hit (the tree adjoint reads words[] itself)
  bool live = false;
  if (p < num_pixels) {
    if constexpr (EXTERNAL_G) {
      for (int ch = 0; ch < 3; ++ch) g[ch] = plane[3 * p + ch];
      live = g[0] != 0.0f || g[1] != 0.0f || g[2] != 0.0f;
    }
    if (!EXTERNAL_G || live) {
      // ---- forward, the residuals into words[] ----
      vx = v[3 * p]; vy = v[3 * p + 1]; vz = v[3 * p + 2];
      float col[3] = {0.0f, 0.0f, 0.0f};
      const int bw_bi = ap.bw_bi, bw_mid = ap.bw_mid;
      auto sink = [&](int k, int bi, int mid, unsigned lit_bits) {
        words[k] = static_cast<unsigned>(bi + 1) +
                   static_cast<unsigned>(mid) * bw_bi +
                   lit_bits * static_cast<unsigned>(bw_bi * bw_mid);
      };
      if constexpr (TREE) {
        const unsigned dead =
            ((1u << prm.nl) - 1u) * static_cast<unsigned>(bw_bi * bw_mid);
        const int nodes = (2 << prm.depth) - 1;
        for (int k = 0; k < nodes; ++k) words[k] = dead;
        tree_forward<WANT_TRANS>(s, prm, vx, vy, vz, col, sink);
      } else {
        hits = chain_forward<WANT_TRANS>(s, prm, vx, vy, vz, col, sink);
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

  // ---- adjoint ----
  GradRecs<kWords> gr;
  gr.init(prm.nl);
  if (live) {
    if constexpr (TREE) {
      tree_adjoint<WANT_TRANS>(s, prm, words, ap.bw_bi, ap.bw_mid, vx, vy, vz,
                               g, gr);
    } else {
      NodeConst cst[kMaxLevels];
      for (int lv = 0; lv < hits; ++lv)
        cst[lv] = unpack_word(words[lv], ap.bw_bi, ap.bw_mid);
      chain_adjoint<WANT_TRANS>(s, prm, cst, hits, vx, vy, vz, g, gr);
    }
  }
  block_column_sums(s, loss, gr, smem + table_floats(prm), ap.ncols,
                    partial + static_cast<size_t>(blockIdx.x) * ap.ncols);
}

using FusedKernel = void (*)(const float*, AdjParams, const float*,
                             const float*, const float*, float*, int);

template <bool EXTERNAL_G>
FusedKernel pick_kernel(bool tree, bool want_trans) {
  if (tree)
    return want_trans ? fused_adjoint_kernel<true, EXTERNAL_G, true>
                      : fused_adjoint_kernel<true, EXTERNAL_G, false>;
  return want_trans ? fused_adjoint_kernel<false, EXTERNAL_G, true>
                    : fused_adjoint_kernel<false, EXTERNAL_G, false>;
}

// Checks the launch's scalars, then launches `kernel` with one thread per
// pixel and the tables plus the warps' column sums in dynamic shared memory.
inline int launch_fused(FusedKernel kernel, bool tree, const float* tables,
                        const AdjParams& ap, const float* v,
                        const float* plane, const float* mask, float* partial,
                        int num_blocks, int num_pixels, cudaStream_t stream) {
  const int depth = ap.prm.depth;
  if (depth < 0 || (tree ? depth > kTreeAdjMaxDepth : depth >= kMaxLevels) ||
      ap.prm.nl < 0 || ap.prm.nl > kMaxLights ||
      num_blocks * kAdjThreads < num_pixels)
    return static_cast<int>(cudaErrorInvalidValue);
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
                            float eye_z, float g_scale, float bw_bi,
                            float bw_mid) {
  AdjParams ap;
  ap.prm = Params{ns, nt, m, nl, depth, white_id, black_id,
                  small, atten, eye_x, eye_y, eye_z};
  ap.g_scale = g_scale;
  ap.bw_bi = static_cast<int>(bw_bi);
  ap.bw_mid = static_cast<int>(bw_mid);
  ap.ncols = 1 + 4 * ns + 9 * m + 3 * nl;
  return ap;
}

}  // namespace rtfs

// C entries (bound with ctypes from kernels/adjoint_fused.py).  `tables` is
// the flat misc | sph | tri | mat | light buffer; v, target and g [P,3],
// mask [P] f32; `partial` is [num_blocks, 1 + 4 ns + 9 m + 3 nl] with
// num_blocks = ceil(P / 256), to be summed by rtfs_adjoint_reduce.  `tree`
// selects the bounce tree (depth <= 5) over the chain (depth <= 15).  Each
// launches on `stream` and returns the launch's cudaError_t.

// K6: forward, L2 cotangent (2/denom = g_scale) and loss, adjoint.
extern "C" int rtfs_fused_adjoint(const float* tables, int ns, int nt, int m,
                                  int nl, const float* v, const float* target,
                                  const float* mask, int num_pixels,
                                  float eye_x, float eye_y, float eye_z,
                                  int depth, float small, float atten,
                                  int white_id, int black_id, int want_trans,
                                  int tree, float g_scale, float bw_bi,
                                  float bw_mid, float* partial,
                                  int num_blocks, void* stream) {
  const rtfs::AdjParams ap =
      rtfs::adj_params(ns, nt, m, nl, depth, white_id, black_id, small, atten,
                       eye_x, eye_y, eye_z, g_scale, bw_bi, bw_mid);
  return rtfs::launch_fused(rtfs::pick_kernel<false>(tree, want_trans), tree,
                            tables, ap, v, target, mask, partial, num_blocks,
                            num_pixels, static_cast<cudaStream_t>(stream));
}

// K7: forward re-trace and adjoint under the external cotangent g; column
// 0 of `partial` (the loss) is 0.
extern "C" int rtfs_recompute_adjoint(const float* tables, int ns, int nt,
                                      int m, int nl, const float* v,
                                      const float* g, int num_pixels,
                                      float eye_x, float eye_y, float eye_z,
                                      int depth, float small, float atten,
                                      int white_id, int black_id,
                                      int want_trans, int tree, float bw_bi,
                                      float bw_mid, float* partial,
                                      int num_blocks, void* stream) {
  const rtfs::AdjParams ap =
      rtfs::adj_params(ns, nt, m, nl, depth, white_id, black_id, small, atten,
                       eye_x, eye_y, eye_z, 0.0f, bw_bi, bw_mid);
  return rtfs::launch_fused(rtfs::pick_kernel<true>(tree, want_trans), tree,
                            tables, ap, v, g, nullptr, partial, num_blocks,
                            num_pixels, static_cast<cudaStream_t>(stream));
}
