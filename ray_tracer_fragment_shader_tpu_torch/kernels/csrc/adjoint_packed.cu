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
// ov_at route) and applies the node adjoint (adjoint_ops.cuh).  The live set
// is one level's record, not the 305 planes of the all-levels form.  Levels
// at and after a miss, and pixels whose cotangent is 0, add exactly zero
// and are skipped.
//
// Gradients must not depend on the order in which blocks run, so no float
// atomics are used.  Each thread keeps, per level, its sphere and material
// cotangents with their ids; the block sums every (entity, field) column in
// a fixed order (a warp butterfly, then the warps in turn) and writes one
// row of a [num_blocks, 1 + 4 ns + 9 m + 3 nl] partial table (column 0 is
// the loss).  adjoint_reduce_kernel then sums the rows in a fixed order.
//
// Bound: bytes.  A pixel reads 28 bytes (img, target, mask); only pixels
// with a nonzero cotangent read their ray and residuals up to the first
// miss and run the adjoint's few hundred FP32 operations per hit level
// (utils/opcount.py).  What this design spends instead is the column
// reduction: every block sums every column, whether or not its pixels
// touched that entity, so with 64 spheres and 66 materials (857 columns) it
// is most of the kernel's time (PERF.md).  Built with -fmad=false
// (kernels/cuda_build.py), so that the replay rounds as the plain version
// does (adjoint_ops.cuh).  This first version aims to be
// right and deterministic; it is not tuned.
#include "adjoint_ops.cuh"

namespace rtfs {

constexpr int kMaxLevels = 16;  // depth <= 15 (adjoint_fused.py)
constexpr int kMaxLights = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct AdjParams {
  Params prm;  // tables, counts, depth, atten, eye
  float g_scale;
  int bw_bi, bw_mid;
  int ncols;
};

// Sum over the 32 lanes; every lane gets the same, order-fixed value.
__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <bool WANT_TRANS>
__global__ void __launch_bounds__(kThreads)
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
  float* wsum = smem + table_floats(prm);  // [kWarps][ncols]
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int depth = prm.depth;

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
      for (; L <= depth; ++L) {
        const int q =
            __float2int_rn(pk[static_cast<size_t>(L) * num_pixels + p]);
        cst[L].bik = q % ap.bw_bi - 1;
        if (cst[L].bik < 0) break;
        cst[L].mid = (q / ap.bw_bi) % ap.bw_mid;
        cst[L].lits = static_cast<unsigned>(q / (ap.bw_bi * ap.bw_mid));
      }
    }
  }

  // ---- primal pass: each level's input ray and throughput ----
  float O[kMaxLevels][3], V[kMaxLevels][3], T[kMaxLevels][3];
  {
    float ox = prm.eye_x, oy = prm.eye_y, oz = prm.eye_z;
    float vx = 0.0f, vy = 0.0f, vz = 0.0f;
    if (L > 0) { vx = v[3 * p]; vy = v[3 * p + 1]; vz = v[3 * p + 2]; }
    float thr[3] = {1.0f, 1.0f, 1.0f};
    for (int lv = 0; lv < L; ++lv) {
      O[lv][0] = ox; O[lv][1] = oy; O[lv][2] = oz;
      V[lv][0] = vx; V[lv][1] = vy; V[lv][2] = vz;
      T[lv][0] = thr[0]; T[lv][1] = thr[1]; T[lv][2] = thr[2];
      if (lv == L - 1) break;
      NodeRec r;
      node_primal(s, cst[lv], ox, oy, oz, vx, vy, vz, WANT_TRANS, &r);
      const float* mt = s.mat + cst[lv].mid * MAT_COLS;
      const bool take_t = WANT_TRANS && mt[13] > 0.5f;
      for (int ch = 0; ch < 3; ++ch)
        thr[ch] *= take_t ? mt[9 + ch] : 1.0f - mt[9 + ch];
      ox = r.px; oy = r.py; oz = r.pz;
      vx = take_t ? r.tx : r.rx;
      vy = take_t ? r.ty : r.ry;
      vz = take_t ? r.tz : r.rz;
    }
  }

  // ---- reverse pass, last hit level down to 0 ----
  float dsph[kMaxLevels][4], dmat[kMaxLevels][9];
  float d_lp[kMaxLights][3];
  for (int li = 0; li < prm.nl; ++li)
    d_lp[li][0] = d_lp[li][1] = d_lp[li][2] = 0.0f;
  float pbx = 0.0f, pby = 0.0f, pbz = 0.0f;  // cotangent of the next o
  float vbx = 0.0f, vby = 0.0f, vbz = 0.0f;  // cotangent of the next v
  for (int lv = L - 1; lv >= 0; --lv) {
    const bool has_child = lv < depth;
    NodeRec r;
    node_primal(s, cst[lv], O[lv][0], O[lv][1], O[lv][2], V[lv][0],
                V[lv][1], V[lv][2], WANT_TRANS && has_child, &r);
    Cot b = {pbx, pby, pbz, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
             0.0f, 0.0f, 0.0f, 0.0f};
    if (has_child) {
      // v_next = take_t ? t : r (the chain's child select)
      const bool take_t =
          WANT_TRANS && s.mat[cst[lv].mid * MAT_COLS + 13] > 0.5f;
      if constexpr (WANT_TRANS) {
        snell_reverse(r, take_t ? vbx : 0.0f, take_t ? vby : 0.0f,
                      take_t ? vbz : 0.0f, &b);
      }
      if (!take_t) { b.rx = vbx; b.ry = vby; b.rz = vbz; }
    }
    for (int k = 0; k < 4; ++k) dsph[lv][k] = 0.0f;
    for (int k = 0; k < 9; ++k) dmat[lv][k] = 0.0f;
    const float g3[3] = {T[lv][0] * g[0], T[lv][1] * g[1], T[lv][2] * g[2]};
    node_reverse(s, cst[lv], r, g3, b, dsph[lv], dmat[lv], d_lp, &pbx, &pby,
                 &pbz, &vbx, &vby, &vbz);
  }

  // ---- block sums of every column, in a fixed order ----
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int col = 0;
  auto put = [&](float x) {
    x = warp_sum(x);
    if (lane == 0) wsum[warp * ap.ncols + col] = x;
    ++col;
  };
  put(loss);
  for (int i = 0; i < s.ns; ++i) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int lv = 0; lv < L; ++lv)
      if (cst[lv].bik == s.nt + i)
        for (int k = 0; k < 4; ++k) acc[k] += dsph[lv][k];
    for (int k = 0; k < 4; ++k) put(acc[k]);
  }
  for (int j = 0; j < s.m; ++j) {
    float acc[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int lv = 0; lv < L; ++lv)
      if (cst[lv].mid == j)
        for (int k = 0; k < 9; ++k) acc[k] += dmat[lv][k];
    for (int k = 0; k < 9; ++k) put(acc[k]);
  }
  for (int li = 0; li < s.nl; ++li)
    for (int k = 0; k < 3; ++k) put(d_lp[li][k]);
  __syncthreads();
  for (int c = threadIdx.x; c < ap.ncols; c += kThreads) {
    float acc = 0.0f;
    for (int w = 0; w < kWarps; ++w) acc += wsum[w * ap.ncols + c];
    partial[static_cast<size_t>(blockIdx.x) * ap.ncols + c] = acc;
  }
}

// out[c] = sum over the rows of partial[:, c], in a fixed order: each
// thread sums a strided set of rows, then a tree over the block.
__global__ void __launch_bounds__(kThreads)
adjoint_reduce_kernel(const float* __restrict__ partial, int num_blocks,
                      int ncols, float* __restrict__ out) {
  __shared__ float buf[kThreads];
  const int c = blockIdx.x;
  float acc = 0.0f;
  for (int b = threadIdx.x; b < num_blocks; b += kThreads)
    acc += partial[static_cast<size_t>(b) * ncols + c];
  buf[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
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
      num_blocks * rtfs::kThreads < num_pixels)
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
  const size_t smem =
      (rtfs::table_floats(ap.prm) + rtfs::kWarps * ap.ncols) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<num_blocks, rtfs::kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(tables, ap, v, img, target,
                                                mask, pk, partial,
                                                num_pixels);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtfs_adjoint_reduce(const float* partial, int num_blocks,
                                   int ncols, float* out, void* stream) {
  rtfs::adjoint_reduce_kernel<<<ncols, rtfs::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      partial, num_blocks, ncols, out);
  return static_cast<int>(cudaGetLastError());
}
