// The fit kernels that make their own forward: K6, the L2 fit's forward,
// loss and adjoint behind one entry, and K7, the per-sample adjoint that
// re-traces each live pixel's forward in the adjoint's thread; each on the
// bounce chain or, for fractional-transparency scenes, the full tree.
//
// Replaces two TPU kernels of the JAX package's kernels/adjoint_fused.py,
// each in its chain and its tree form:
//   K6  _fused_fwd_bwd_kernel (:1031), launched by fused_loss_grads_pallas
//       (:1550): the L2 cotangent g = g_scale * mask * (img - target) and
//       the squared-error term formed from a target (rtfs_fused_adjoint);
//   K7  _recompute_bwd_kernel (:1123), launched by recompute_grads_pallas
//       (:1250): the cotangent planes g come from outside
//       (rtfs_recompute_adjoint).
// The chain adjoint is _adjoint_tile_body (:387-635), the tree adjoint
// _adjoint_tree_tile_body (:638-793); both are in adjoint_ops.cuh.
//
// K6 on the chain is three steps on this card, where the TPU kernel is one:
// 1. the chain forward's RECORDS form (render_chain.cu: the render
//    kernel's own code and launch bounds, one block per 256 pixels) writes
//    each hit level's 8-byte topology record (bi, mid, lit bits) per pixel
//    (tile_ops.cuh::RecordWriter), where the TPU kernel kept them in VMEM
//    scratch, and marks its block for K4's live list on (img, target, mask)
//    with the mark code of adjoint_packed.cu's live_mark_kernel
//    (tile_ops.cuh::mark_live: per warp the ballot of the pixels whose
//    cotangent is nonzero, per block their count and the squared-error
//    sum in a fixed order, which make K6's loss); a live pixel writes its
//    image and its count of levels;
// 2. the rest of the live list (adjoint_packed.cu::rtfs_live_ids: a scan
//    of the blocks' counts and a scatter of the live pixels' ids);
// 3. records_adjoint_kernel over the live list: a warp holds 32 live
//    pixels, each reads its records and runs chain_adjoint (no re-trace);
//    then rtfs_adjoint_reduce.
// Every step is K3+K4's but for the records in place of the pack (the
// forward's image code, the live list's code, chain_adjoint on the same
// topology, the same grid and sums), so its loss and tables equal K3+K4's
// bit for bit.
//
// Bound: operations.  A pixel reads 28 bytes (ray, target, mask) and
// writes 8 per level that hits, a live one 16 more; a live pixel's adjoint
// reads its records and 40 bytes more.  Against that, the forward's
// thousands of FP32 operations per pixel and the adjoint's few hundred per
// live level.  What held the one-dispatch chain back was registers: the
// forward ran in the adjoint's thread at the adjoint's 120-128 registers,
// 2 blocks of 256 a SM where the chain forward holds 3-4 (its time follows
// the warps a SM holds, PERF.md §6), and every pixel's adjoint stepped in
// warps of 5-24 % live lanes.  Split so, the forward runs at the forward
// kernel's budget and the adjoint on full warps.  The block's mark waits
// for no warp (an integer count in shared memory elects the last one to
// sum the block): on an H100 a barrier there cost config 5 2.6 %, and a
// look-back for the ids' places in the forward, in place of the scan and
// the scatter, held each block on its SM until the blocks before it had
// finished (PERF.md §6).
//
// K6 on the tree, and K7, are one dispatch: each thread traces its pixel's
// forward (tile_ops.cuh's chain_forward or tree_forward, the render
// kernels' own code) into per-thread records, then runs its adjoint.  The
// split was measured on the tree too and ran no faster on an H100
// (PERF.md §6): a tree fit's live pixels are few and its adjoint is
// latency-bound on them, and where every pixel is live the split took
// 1.33 times as long.
// K7 runs on the compacted list of the pixels whose g is nonzero
// (rtfs_live_list, built on the device before it), so a warp holds 32 live
// pixels and no thread traces a pixel that adds nothing; K6's tree runs on
// every pixel (its forward makes the cotangent).  Each block walks chunks
// of 256 (blockIdx.x, + gridDim.x, ...; at most kAdjGridCap blocks).  The
// tree form is instantiated for each depth cap of kTreeAdjDepthCaps, since
// CUDA reserves a kernel's local memory for every thread the card can
// hold.
//
// Every adjoint replays in f32 on the records whatever the forward's
// precision (BF16: the bf16_shading forward), and sums each node's
// cotangents into sparse, fixed-order block sums (adjoint_ops.cuh::
// BlockSums), reduced in a fixed order by adjoint_packed.cu::
// adjoint_reduce_kernel: no float atomics, two launches bit-identical.
// Built, as every kernel, with -fmad=false (kernels/cuda_build.py), so the
// topology the adjoint replays is the one the plain version's forward
// picks, and the replay rounds as the plain version does.
#include <type_traits>

#include "adjoint_ops.cuh"

namespace rtfs {

// The tree depths the one-dispatch tree form is instantiated for, smallest
// first: 5, the reference's own depth (63 nodes a thread), 7, and 10, the
// tree forward's own limit (tile_ops.cuh::kTreeMaxDepth; kernels/
// adjoint_fused.py::TREE_ADJOINT_DEPTH_CAPS).  Local memory a thread: 6
// bytes a preorder node plus the frames (ptxas's figures per cap are in
// PERF.md), reserved for every resident thread only while the deepest cap
// launched so far is in use.
constexpr int kTreeAdjDepthCaps[] = {5, 7, 10};
constexpr int kTreeAdjMaxDepth = kTreeAdjDepthCaps[2];
static_assert(kTreeAdjMaxDepth == kTreeMaxDepth,
              "the tree adjoint holds every tree the tree forward holds");

// ---- K6 on the chain: the adjoint over the live list, on the records --

// ids[0..*count) are the live pixels (the live list on img, target, mask),
// rec [depth+1][num_pixels] and rec_n [num_pixels] the records forward's.
template <bool WANT_TRANS>
__global__ void __launch_bounds__(kAdjThreads)
records_adjoint_kernel(const float* __restrict__ tables, AdjParams ap,
                       const float* __restrict__ v,
                       const float* __restrict__ img,
                       const float* __restrict__ target,
                       const float* __restrict__ mask,
                       const NodeRecord* __restrict__ rec,
                       const int* __restrict__ rec_n,
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
    int p = 0, L = 0;  // the pixel and its records
    if (q < n) {
      // the cotangent, as the live pass formed it (K4's prologue)
      p = ids[q];
      const float mk = mask[p];
      for (int ch = 0; ch < 3; ++ch)
        g[ch] = ap.g_scale * ((img[3 * p + ch] - target[3 * p + ch]) * mk);
      vx = v[3 * p]; vy = v[3 * p + 1]; vz = v[3 * p + 2];
      L = rec_n[p];
    }
    NodeConst cst[kMaxLevels];
    for (int lv = 0; lv < L; ++lv) {
      const NodeRecord r = rec[static_cast<size_t>(lv) * num_pixels + p];
      cst[lv] = NodeConst{r.bik, r.mid, r.lits};
    }
    chain_adjoint<WANT_TRANS>(s, prm, cst, L, vx, vy, vz, g, sums, d_lp);
  }
  sums.finish(0.0f, d_lp,
              partial + static_cast<size_t>(blockIdx.x) * ap.ncols);
}

using RecordsKernel = void (*)(const float*, AdjParams, const float*,
                               const float*, const float*, const float*,
                               const NodeRecord*, const int*, const int*,
                               const int*, float*, int);

inline RecordsKernel pick_records(bool want_trans) {
  return want_trans ? records_adjoint_kernel<true>
                    : records_adjoint_kernel<false>;
}

// ---- K6 on the tree, and K7: one dispatch --------------------------------

// TREE_CAP: the deepest tree the per-thread arrays hold (tree form only).
// K7 (EXTERNAL_G) reads the live pixels' ids ids[0..*count) and their g;
// K6 (the tree form only) every pixel's target and mask.
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

// The instantiation for the launch's flags: the chain (K7 only), or the
// tree at the smallest depth cap that holds `depth`.
template <bool EXTERNAL_G>
FusedKernel pick_kernel(bool tree, bool want_trans, bool bf16, int depth) {
  if constexpr (EXTERNAL_G) {
    if (!tree) return pick_flags<false, true, 0>(want_trans, bf16);
  }
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


// Launches K6's chain adjoint on the live list with num_blocks blocks and
// the tables plus the block sums in dynamic shared memory.
inline int launch_records(bool want_trans, const float* tables,
                          const AdjParams& ap, const float* v,
                          const float* img, const float* target,
                          const float* mask, const NodeRecord* rec,
                          const int* rec_n, const int* ids, const int* count,
                          float* partial, int num_blocks, int num_pixels,
                          cudaStream_t stream) {
  const RecordsKernel kernel = pick_records(want_trans);
  const size_t smem = adjoint_smem_bytes(ap);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<num_blocks, kAdjThreads, smem, stream>>>(
      tables, ap, v, img, target, mask, rec, rec_n, ids, count, partial,
      num_pixels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rtfs

// The passes K6's chain runs before its adjoint (render_chain.cu,
// adjoint_packed.cu).
extern "C" {
int rtfs_render_chain_records(const float* tables, int ns, int nt, int m,
                              int nl, const float* v, float* out,
                              int num_pixels, float eye_x, float eye_y,
                              float eye_z, int depth, float small,
                              float atten, int white_id, int black_id,
                              int want_trans, int bf16, void* rec,
                              int* rec_n, const float* target,
                              const float* mask, float g_scale,
                              unsigned* ballots, int* counts,
                              float* loss_rows, void* stream);
int rtfs_live_ids(const unsigned* ballots, const int* counts, int num_pixels,
                  int* offsets, int* ids, int* count, void* stream);
}

// C entries (bound with ctypes from kernels/adjoint_fused.py).  `tables` is
// the flat misc | sph | tri | mat | light buffer; v, target and g [P,3],
// mask [P] f32; `partial` is [num_blocks, 1 + 4 ns + 9 m + 3 nl] with
// num_blocks = min(ceil(P / 256), kAdjGridCap), to be summed by
// rtfs_adjoint_reduce.  `tree` selects the bounce tree (depth <=
// kTreeAdjMaxDepth) over the chain (depth <= 15), `bf16` the bf16_shading
// forward.  Each launches on `stream` and returns the first cudaError_t of
// its launches that is not cudaSuccess.

// K6: forward, L2 cotangent (2/denom = g_scale) and loss, adjoint.  On the
// chain: the records forward (img [P,3], rec [depth+1, P] 8-byte records,
// rec_n [P] int) with the live list's marks of (img, target, mask), the
// rest of the live list (scratch ballots [B * 8], counts and offsets [B],
// B = max(ceil(P/256), 1); out: loss_rows [B], ids [P], count [1], as
// rtfs_live_list's), then the adjoint over it; column 0 of `partial` is 0
// and rtfs_adjoint_reduce takes the loss from loss_rows.  On the tree one
// dispatch, which takes none of that scratch (null pointers will do) and
// sums the loss into column 0 of `partial`.
extern "C" int rtfs_fused_adjoint(const float* tables, int ns, int nt, int m,
                                  int nl, const float* v, const float* target,
                                  const float* mask, int num_pixels,
                                  float eye_x, float eye_y, float eye_z,
                                  int depth, float small, float atten,
                                  int white_id, int black_id, int want_trans,
                                  int tree, int bf16, float g_scale,
                                  float* img, void* rec, int* rec_n,
                                  unsigned* ballots, int* counts,
                                  int* offsets, float* loss_rows, int* ids,
                                  int* count, float* partial, int num_blocks,
                                  void* stream) {
  const rtfs::AdjParams ap =
      rtfs::adj_params(ns, nt, m, nl, depth, white_id, black_id, small, atten,
                       eye_x, eye_y, eye_z, g_scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tree)
    return rtfs::launch_fused<false>(true, want_trans, bf16, tables, ap, v,
                                     target, mask, nullptr, nullptr, partial,
                                     num_blocks, num_pixels, st);
  if (depth < 0 || depth >= rtfs::kMaxLevels || nl < 0 ||
      nl > rtfs::kMaxLights || nt + ns > 32767 || m > 32767 ||
      num_blocks != rtfs::adjoint_blocks(num_pixels))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = rtfs_render_chain_records(
      tables, ns, nt, m, nl, v, img, num_pixels, eye_x, eye_y, eye_z, depth,
      small, atten, white_id, black_id, want_trans, bf16, rec, rec_n, target,
      mask, g_scale, ballots, counts, loss_rows, stream);
  if (rc == 0)
    rc = rtfs_live_ids(ballots, counts, num_pixels, offsets, ids, count,
                       stream);
  if (rc != 0) return rc;
  return rtfs::launch_records(want_trans, tables, ap, v, img, target, mask,
                              static_cast<const rtfs::NodeRecord*>(rec),
                              rec_n, ids, count, partial, num_blocks,
                              num_pixels, st);
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

// Blocks of 256 one SM holds at once with `smem_bytes` of tables and sums,
// into *blocks: of the one-dispatch kernel's instantiation for (tree,
// external_g: K7 or K6's tree form, want_trans, bf16, depth's cap), and of
// K6's chain adjoint for want_trans.
extern "C" int rtfs_fused_occupancy(int tree, int external_g, int want_trans,
                                    int bf16, int depth, int smem_bytes,
                                    int* blocks) {
  if (!tree && !external_g) return static_cast<int>(cudaErrorInvalidValue);
  const rtfs::FusedKernel k =
      external_g ? rtfs::pick_kernel<true>(tree, want_trans, bf16, depth)
                 : rtfs::pick_kernel<false>(true, want_trans, bf16, depth);
  const cudaError_t e = rtfs::kernel_occupancy(k, smem_bytes, blocks);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" int rtfs_records_occupancy(int want_trans, int smem_bytes,
                                      int* blocks) {
  const cudaError_t e = rtfs::kernel_occupancy(
      rtfs::pick_records(want_trans), smem_bytes, blocks);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
