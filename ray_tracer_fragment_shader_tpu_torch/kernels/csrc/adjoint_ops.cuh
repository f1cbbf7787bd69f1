// Device code of the hand-written replay adjoints (adjoint_packed.cu,
// adjoint_fused.cu, fit_grads.cu): one bounce node's primal record and its
// reverse sweep, per pixel, the counterparts of the JAX package's
// kernels/adjoint_fused.py::_node_primal (:274-362), _snell_reverse
// (:365-384) and _node_reverse (:71-262); the chain's and the tree's
// adjoint over them (_adjoint_tile_body :387-635, _adjoint_tree_tile_body
// :638-793), in warp-uniform steps; and the sparse, fixed-order block sums
// of the gradient columns (BlockSums), which take each node's cotangents as
// it finishes, so that no thread keeps gradient records.
//
// A node here is a hit node: the adjoint kernel skips levels at and after a
// lane's miss, whose every term is masked to exactly zero in the JAX code.
// For the same reason the sphere terms of a triangle hit and the triangle
// terms of a sphere hit are not computed (their cotangents are masked to
// zero there), and an unlit light adds nothing.
//
// Rounding.  node_primal evaluates the replay in the plain version's order
// (kernels/adjoint.py::_node_math), operation for operation: IEEE sqrtf, a
// reciprocal by IEEE division where it divides, and, because every kernel
// is built with -fmad=false, no fused multiply-add.  A
// chain of convex mirrors amplifies the rounding of a far sphere's
// disc = ud^2 - |d|^2 + r^2 (a difference of numbers near 1e5) from bounce
// to bounce; rounded otherwise than the plain version, the replay can land
// on another side of a silhouette, and the gradients part (PERF.md, PR 2).
#pragma once

#include "tile_ops.cuh"

namespace rtfs {

// 1/sqrt(x) for x > 0, else 0 (IEEE sqrt and division)
__device__ __forceinline__ float inv_sqrt(float x) {
  return x > 0.0f ? 1.0f / sqrtf(x) : 0.0f;
}

// sqrt(x) for x > 0, else 0 (the plain version's safe_sqrt)
__device__ __forceinline__ float safe_sqrt(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}

// 1/x for a nonzero x, else 0 (its safe_div(1, x))
__device__ __forceinline__ float safe_recip(float x) {
  return x != 0.0f ? 1.0f / x : 0.0f;
}

// sign with sign(0) = 0, as jnp.sign
__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>((x > 0.0f) - (x < 0.0f));
}

// The pinned topology of one hit node: primitive id, material id, lit bits.
struct NodeConst {
  int bik, mid;
  unsigned lits;
};

// What the reverse sweep reads of one node's primal (the JAX `rec`).
struct NodeRec {
  float vx, vy, vz, ivl, ux, uy, uz;
  bool is_tri;
  float tnx, tny, tnz, inv_ndv, m_par;  // triangle hits
  bool ndv_ok;
  float cx, cy, cz, rr, dx, dy, dz, ud, inv_sq;  // sphere hits
  bool disc_ok;
  float d0x, d0y, d0z, inv_d0;
  float bd, px, py, pz, nx, ny, nz, cosi, rx, ry, rz;
  float rho, mod_f, inv_cosr, coef, tx, ty, tz;  // Snell (want_snell)
};

// Primal of node `c` on ray (o, v): hit point, normal, reflected and (with
// want_snell) transmitted directions, and every intermediate the reverse
// reads.  Parameter values come from the scene tables (sph[:, 0:4] are the
// centre and radius).
__device__ __forceinline__ void node_primal(const Scene& s,
                                            const NodeConst& c, float ox,
                                            float oy, float oz, float vx,
                                            float vy, float vz,
                                            bool want_snell, NodeRec* r) {
  r->vx = vx; r->vy = vy; r->vz = vz;
  const float vlen2 = vx * vx + vy * vy + vz * vz;
  r->ivl = safe_recip(safe_sqrt(vlen2));
  r->ux = vx * r->ivl; r->uy = vy * r->ivl; r->uz = vz * r->ivl;
  r->is_tri = c.bik < s.nt;
  if (r->is_tri) {
    const float* t = s.tri + c.bik * TRI_COLS;
    r->tnx = t[3]; r->tny = t[4]; r->tnz = t[5];
    const float ndv = r->tnx * vx + r->tny * vy + r->tnz * vz;
    r->ndv_ok = fabsf(ndv) > 0.0f;
    r->inv_ndv = 1.0f / (r->ndv_ok ? ndv : 1.0f);
    const float ndo = r->tnx * ox + r->tny * oy + r->tnz * oz;
    r->m_par = r->ndv_ok ? (t[16] - ndo) / ndv : 0.0f;
    r->cx = r->cy = r->cz = r->rr = 0.0f;
  } else {
    const float* sp = s.sph + (c.bik - s.nt) * SPH_COLS;
    r->cx = sp[0]; r->cy = sp[1]; r->cz = sp[2]; r->rr = sp[3];
    r->dx = r->cx - ox; r->dy = r->cy - oy; r->dz = r->cz - oz;
    r->ud = r->ux * r->dx + r->uy * r->dy + r->uz * r->dz;
    const float disc = r->ud * r->ud -
                       (r->dx * r->dx + r->dy * r->dy + r->dz * r->dz) +
                       r->rr * r->rr;
    r->disc_ok = disc > 0.0f;
    const float sq = safe_sqrt(disc);
    r->inv_sq = safe_recip(sq);
    r->bd = r->ud - sq;
  }
  // a triangle's point is o + m_par*v, as the forwards' (tile_ops.cuh::
  // hit_attrs), a sphere's o + bd*u
  const float k = r->is_tri ? r->m_par : r->bd;
  r->px = ox + k * (r->is_tri ? vx : r->ux);
  r->py = oy + k * (r->is_tri ? vy : r->uy);
  r->pz = oz + k * (r->is_tri ? vz : r->uz);
  if (r->is_tri) {
    r->nx = r->tnx; r->ny = r->tny; r->nz = r->tnz;
  } else {
    r->d0x = r->px - r->cx; r->d0y = r->py - r->cy; r->d0z = r->pz - r->cz;
    const float d0sq = r->d0x * r->d0x + r->d0y * r->d0y + r->d0z * r->d0z;
    r->inv_d0 = inv_sqrt(d0sq);
    r->nx = r->d0x * r->inv_d0;
    r->ny = r->d0y * r->inv_d0;
    r->nz = r->d0z * r->inv_d0;
  }
  r->cosi = r->ux * r->nx + r->uy * r->ny + r->uz * r->nz;
  r->rx = r->ux - 2.0f * r->cosi * r->nx;
  r->ry = r->uy - 2.0f * r->cosi * r->ny;
  r->rz = r->uz - 2.0f * r->cosi * r->nz;
  if (want_snell) {
    const float rho = s.mat[c.mid * MAT_COLS + 12];
    r->rho = rho;
    const float modulus = 1.0f - rho * rho * (1.0f - r->cosi * r->cosi);
    const bool mod_ok = modulus > 0.0f;
    const float cosr = safe_sqrt(modulus);
    r->inv_cosr = safe_recip(cosr);
    r->mod_f = mod_ok ? 1.0f : 0.0f;
    r->coef = cosr + rho * r->cosi;
    r->tx = (rho * r->ux - r->coef * r->nx) * r->mod_f;
    r->ty = (rho * r->uy - r->coef * r->ny) * r->mod_f;
    r->tz = (rho * r->uz - r->coef * r->nz) * r->mod_f;
  }
}

// Cotangents of one node: of its ray (o, v) out, of its hit point, unit
// direction, normal, reflected direction and cosi flowing in.
struct Cot {
  float px, py, pz, ux, uy, uz, nx, ny, nz, rx, ry, rz, cosi;
};

// Adjoint of t = (rho*u - coef*n)*mod_f for the cotangent tb of t.
__device__ __forceinline__ void snell_reverse(const NodeRec& r, float tbx,
                                              float tby, float tbz, Cot* b) {
  const float rho_mf = r.rho * r.mod_f;
  b->ux += rho_mf * tbx; b->uy += rho_mf * tby; b->uz += rho_mf * tbz;
  const float cmf = r.coef * r.mod_f;
  b->nx -= cmf * tbx; b->ny -= cmf * tby; b->nz -= cmf * tbz;
  const float coef_b = -r.mod_f * (tbx * r.nx + tby * r.ny + tbz * r.nz);
  // coef = cosr + rho*cosi; cosr = sqrt(modulus);
  // modulus = 1 - rho^2 (1 - cosi^2)
  b->cosi += r.rho * coef_b;
  const float mod_b = 0.5f * r.inv_cosr * coef_b;
  b->cosi += mod_b * (2.0f * r.rho * r.rho) * r.cosi;
}

// Reverse sweep of one hit node.  g3 is the per-channel cotangent of its
// local shading (throughput times the image cotangent), b the cotangents
// flowing in from its child.  Adds the node's parameter cotangents to
// d_sph (centre xyz, radius; sphere hits only), d_mat (ambient, diffuse,
// specular) and d_lp[li] (light positions), and returns the cotangents of
// its input ray in (obx..), (vbx..).
__device__ __forceinline__ void node_reverse(
    const Scene& s, const NodeConst& c, const NodeRec& r, const float g3[3],
    Cot b, float d_sph[4], float d_mat[9], float (*d_lp)[3], float* obx,
    float* oby, float* obz, float* vbx, float* vby, float* vbz) {
  const float* mt = s.mat + c.mid * MAT_COLS;  // amb(0:3) dif(3:6) spe(6:9)
  const float inv_atten = -1.0f / s.atten;
  for (int li = 0; li < s.nl; ++li) {
    if (!((c.lits >> li) & 1u)) continue;  // unlit: weight 0, adds zero
    const float* L = s.light + li * LIGHT_COLS;
    const float svx = L[0] - r.px, svy = L[1] - r.py, svz = L[2] - r.pz;
    const float d2 = svx * svx + svy * svy + svz * svz;
    const float att = s.atten * (1.0f / (s.atten + d2));
    const float inv_sl = inv_sqrt(d2);
    const float dot_ns = r.nx * svx + r.ny * svy + r.nz * svz;
    const float dot_ur = r.ux * r.rx + r.uy * r.ry + r.uz * r.rz;
    const float abs_ns = fabsf(dot_ns);
    const float ndots = abs_ns * inv_sl;
    const float udotr = fabsf(dot_ur);
    const float k[3] = {att * (L[3] * g3[0]), att * (L[4] * g3[1]),
                        att * (L[5] * g3[2])};
    for (int ch = 0; ch < 3; ++ch) {
      d_mat[ch] += k[ch];
      d_mat[3 + ch] += k[ch] * ndots;
      d_mat[6 + ch] += k[ch] * udotr;
    }
    const float ndots_b = k[0] * mt[3] + k[1] * mt[4] + k[2] * mt[5];
    const float udotr_b = k[0] * mt[6] + k[1] * mt[7] + k[2] * mt[8];
    const float s_r = mt[0] + ndots * mt[3] + udotr * mt[6];
    const float s_g = mt[1] + ndots * mt[4] + udotr * mt[7];
    const float s_b = mt[2] + ndots * mt[5] + udotr * mt[8];
    const float att_b =
        g3[0] * L[3] * s_r + g3[1] * L[4] * s_g + g3[2] * L[5] * s_b;
    // att = A/(A+d2): d att / d d2 = -att^2/A
    float d2_b = att_b * att * att * inv_atten;
    // udotr = |u.r|
    const float dur_b = udotr_b * sgn(dot_ur);
    b.ux += dur_b * r.rx; b.uy += dur_b * r.ry; b.uz += dur_b * r.rz;
    b.rx += dur_b * r.ux; b.ry += dur_b * r.uy; b.rz += dur_b * r.uz;
    // ndots = |n.sv| * inv_sl; inv_sl = d2^-1/2
    const float dns_b = ndots_b * inv_sl * sgn(dot_ns);
    d2_b += ndots_b * abs_ns * (-0.5f) * inv_sl * inv_sl * inv_sl;
    b.nx += dns_b * svx; b.ny += dns_b * svy; b.nz += dns_b * svz;
    const float sv_bx = dns_b * r.nx + 2.0f * d2_b * svx;
    const float sv_by = dns_b * r.ny + 2.0f * d2_b * svy;
    const float sv_bz = dns_b * r.nz + 2.0f * d2_b * svz;
    // sv = lp - p
    d_lp[li][0] += sv_bx; d_lp[li][1] += sv_by; d_lp[li][2] += sv_bz;
    b.px -= sv_bx; b.py -= sv_by; b.pz -= sv_bz;
  }

  // r = u - 2 cosi n
  b.ux += b.rx; b.uy += b.ry; b.uz += b.rz;
  b.cosi -= 2.0f * (b.rx * r.nx + b.ry * r.ny + b.rz * r.nz);
  const float two_cosi = 2.0f * r.cosi;
  b.nx -= two_cosi * b.rx; b.ny -= two_cosi * b.ry; b.nz -= two_cosi * b.rz;
  // cosi = u.n
  b.ux += b.cosi * r.nx; b.uy += b.cosi * r.ny; b.uz += b.cosi * r.nz;
  b.nx += b.cosi * r.ux; b.ny += b.cosi * r.uy; b.nz += b.cosi * r.uz;

  float ox_b, oy_b, oz_b, vx_b, vy_b, vz_b;
  if (r.is_tri) {
    // n = tn (a constant); p = o + m_par*v
    ox_b = b.px; oy_b = b.py; oz_b = b.pz;
    const float m_b = b.px * r.vx + b.py * r.vy + b.pz * r.vz;
    vx_b = r.m_par * b.px; vy_b = r.m_par * b.py; vz_b = r.m_par * b.pz;
    // m_par = (tnv0 - tn.o) / ndv; ndv = tn.v
    const float ndo_b = r.ndv_ok ? -m_b * r.inv_ndv : 0.0f;
    const float ndv_b = -r.m_par * r.inv_ndv * m_b;
    ox_b += ndo_b * r.tnx; oy_b += ndo_b * r.tny; oz_b += ndo_b * r.tnz;
    vx_b += ndv_b * r.tnx; vy_b += ndv_b * r.tny; vz_b += ndv_b * r.tnz;
    // u = v * ivl
    vx_b += b.ux * r.ivl; vy_b += b.uy * r.ivl; vz_b += b.uz * r.ivl;
  } else {
    // n = d0 * inv_d0; inv_d0 = d0sq^-1/2; d0 = p - c
    const float invd0_b = b.nx * r.d0x + b.ny * r.d0y + b.nz * r.d0z;
    const float d0sq_b = (-0.5f) * r.inv_d0 * r.inv_d0 * r.inv_d0 * invd0_b;
    const float two_d0sq_b = 2.0f * d0sq_b;
    const float d0_bx = r.inv_d0 * b.nx + two_d0sq_b * r.d0x;
    const float d0_by = r.inv_d0 * b.ny + two_d0sq_b * r.d0y;
    const float d0_bz = r.inv_d0 * b.nz + two_d0sq_b * r.d0z;
    b.px += d0_bx; b.py += d0_by; b.pz += d0_bz;
    float c_bx = -d0_bx, c_by = -d0_by, c_bz = -d0_bz;
    // p = o + bd*u
    ox_b = b.px; oy_b = b.py; oz_b = b.pz;
    const float bd_b = b.px * r.ux + b.py * r.uy + b.pz * r.uz;
    b.ux += r.bd * b.px; b.uy += r.bd * b.py; b.uz += r.bd * b.pz;
    // bd = ud - sqrt(disc); disc = ud^2 - d.d + rr^2; ud = u.d; d = c - o
    const float disc_b = r.disc_ok ? (-0.5f) * r.inv_sq * bd_b : 0.0f;
    const float ud_b = bd_b + 2.0f * r.ud * disc_b;
    d_sph[3] += 2.0f * r.rr * disc_b;
    const float neg2disc_b = -2.0f * disc_b;
    const float d_bx = neg2disc_b * r.dx + ud_b * r.ux;
    const float d_by = neg2disc_b * r.dy + ud_b * r.uy;
    const float d_bz = neg2disc_b * r.dz + ud_b * r.uz;
    b.ux += ud_b * r.dx; b.uy += ud_b * r.dy; b.uz += ud_b * r.dz;
    c_bx += d_bx; c_by += d_by; c_bz += d_bz;
    ox_b -= d_bx; oy_b -= d_by; oz_b -= d_bz;
    d_sph[0] += c_bx; d_sph[1] += c_by; d_sph[2] += c_bz;
    // u = v * ivl
    vx_b = b.ux * r.ivl; vy_b = b.uy * r.ivl; vz_b = b.uz * r.ivl;
  }
  // ivl = 1/sqrt(vlen2)
  const float ivl_b = b.ux * r.vx + b.uy * r.vy + b.uz * r.vz;
  const float vlen_b = -r.ivl * r.ivl * ivl_b;
  const float two_vlen2_b = 2.0f * (0.5f * vlen_b * r.ivl);
  vx_b += two_vlen2_b * r.vx; vy_b += two_vlen2_b * r.vy;
  vz_b += two_vlen2_b * r.vz;
  *obx = ox_b; *oby = oy_b; *obz = oz_b;
  *vbx = vx_b; *vby = vy_b; *vbz = vz_b;
}

// ---- what the adjoint kernels (K4, K6, K7, K8) share --------------------

constexpr int kMaxLevels = 16;  // chain depth <= 15 (adjoint_fused.py)
constexpr int kMaxLights = 16;
// Preorder nodes of a bounce tree of depth d: 2^(d+1) - 1.
__host__ __device__ constexpr int tree_nodes(int depth) {
  return (2 << depth) - 1;
}
constexpr int kAdjThreads = 256;
constexpr int kAdjWarps = kAdjThreads / 32;
// Most blocks an adjoint launch runs; each walks the chunks of 256 pixels
// blockIdx.x, blockIdx.x + gridDim.x, ... (kernels/adjoint_fused.py::
// ADJOINT_GRID_CAP).  A constant, so the assignment of pixels to blocks, and
// with it every sum's order, is the same on every launch and every card.
constexpr int kAdjGridCap = 1024;
// Floats of one node's sparse cotangents: sphere (4) then material (9).
constexpr int kRecFloats = 13;

struct AdjParams {
  Params prm;  // tables, counts, depth, atten, eye (and the forward's)
  float g_scale;
  int bw_bi, bw_mid;  // pack widths (kernels/render.py::pack_widths)
  int ncols;          // 1 + 4 ns + 9 m + 3 nl
};

// The pinned topology of a packed word (bi+1) + mid*bw_bi + lits*bw_bi*bw_mid
// (K4's residual plane).
__device__ __forceinline__ NodeConst unpack_word(unsigned q, int bw_bi,
                                                 int bw_mid) {
  NodeConst c;
  c.bik = static_cast<int>(q % bw_bi) - 1;
  c.mid = static_cast<int>((q / bw_bi) % bw_mid);
  c.lits = q / (bw_bi * bw_mid);
  return c;
}

// A tree node's topology as the tree forms keep it, one per preorder node:
// 6 bytes (ids below 2^15, as the shared-memory tables keep them, and at
// most kMaxLights lit bits), where NodeConst takes 12.
struct TreeRec {
  short bik, mid;
  unsigned short lits;
};

__device__ __forceinline__ NodeConst unpack_rec(const TreeRec& r) {
  return NodeConst{r.bik, r.mid, r.lits};
}

// The gradient sums of one adjoint block, in shared memory after the
// tables: per warp a row [loss | sph(ns x 4) | mat(m x 9) | light(nl x 3)]
// of ncols, zeroed once, and a staging area of 32 node records.
//
// add() takes one finished node from each lane of a warp (all lanes call
// it, at a warp-uniform point) and adds into the warp's own row only the
// columns those nodes touch: __match_any_sync groups the lanes by sphere
// (sphere hits only) and, apart, by material; each group's lowest lane sums
// the group's records in lane order (a full warp of one id: a butterfly)
// and adds the sum to its columns.  Groups touch disjoint columns, so no
// two lanes write one column, and no float atomics are needed.  finish()
// adds the dense columns (the loss and the lights, per thread over its
// pixels, then a butterfly), then sums the warp rows in warp order into the
// block's row of the partial table.  Every order is fixed by the pixel's
// place in the launch, so two launches are bit-identical.
struct BlockSums {
  float* row;    // this warp's row
  float* stage;  // this warp's [32][kRecFloats]
  float* rows;   // all warps' rows
  int ncols, nt, mat0, light0, nl;

  // Every thread of the block must construct it (it synchronises).
  __device__ BlockSums(float* smem, const Params& prm, int ncols_)
      : ncols(ncols_), nt(prm.nt), mat0(1 + 4 * prm.ns),
        light0(1 + 4 * prm.ns + 9 * prm.m), nl(prm.nl) {
    rows = smem;
    row = rows + (threadIdx.x >> 5) * ncols;
    stage = rows + kAdjWarps * ncols + (threadIdx.x >> 5) * 32 * kRecFloats;
    for (int i = threadIdx.x; i < kAdjWarps * ncols; i += kAdjThreads)
      rows[i] = 0.0f;
    __syncthreads();
  }

  // The sum of `k` floats at offset `off` of the records of `group` (a lane
  // mask holding this lane, its lowest), into dst.
  template <int N>
  __device__ __forceinline__ void group_add(unsigned group, int off,
                                            float* dst) {
    const int lane = threadIdx.x & 31;
    const float* mine = stage + lane * kRecFloats + off;
    float a[N];
    for (int k = 0; k < N; ++k) a[k] = mine[k];
    for (unsigned m = group & (group - 1u); m != 0u; m &= m - 1u) {
      const float* o = stage + (__ffs(m) - 1) * kRecFloats + off;
      for (int k = 0; k < N; ++k) a[k] += o[k];
    }
    for (int k = 0; k < N; ++k) dst[k] += a[k];
  }

  // A full warp of one id: a butterfly over the lanes' own values.
  template <int N>
  __device__ __forceinline__ void warp_add(const float* x, float* dst) {
    float a[N];
    for (int k = 0; k < N; ++k) a[k] = warp_sum(x[k]);
    if ((threadIdx.x & 31) == 0)
      for (int k = 0; k < N; ++k) dst[k] += a[k];
  }

  // Node c's cotangents dsph (its sphere's centre and radius) and dmat (its
  // material's ambient, diffuse, specular) from the lanes with `on`.
  __device__ void add(bool on, const NodeConst& c, const float dsph[4],
                      const float dmat[9]) {
    if (__ballot_sync(kFullMask, on) == 0u) return;
    const int lane = threadIdx.x & 31;
    const int sk = (on && c.bik >= nt) ? c.bik - nt : -1;
    const int mk = on ? c.mid : -1;
    const unsigned sg = __match_any_sync(kFullMask, sk);
    const unsigned mg = __match_any_sync(kFullMask, mk);
    if (sg == kFullMask && mg == kFullMask) {  // warp-uniform
      if (sk >= 0) warp_add<4>(dsph, row + 1 + 4 * sk);
      warp_add<9>(dmat, row + mat0 + 9 * mk);
      __syncwarp();
      return;
    }
    if (on) {
      float* mine = stage + lane * kRecFloats;
      for (int k = 0; k < 4; ++k) mine[k] = dsph[k];
      for (int k = 0; k < 9; ++k) mine[4 + k] = dmat[k];
    }
    __syncwarp();
    if (sk >= 0 && lane == __ffs(sg) - 1)
      group_add<4>(sg, 0, row + 1 + 4 * sk);
    if (mk >= 0 && lane == __ffs(mg) - 1)
      group_add<9>(mg, 4, row + mat0 + 9 * mk);
    __syncwarp();
  }

  // Every thread of the block must call it, once, after its last add().
  __device__ void finish(float loss, float (*d_lp)[3],
                         float* __restrict__ out) {
    const bool lead = (threadIdx.x & 31) == 0;
    loss = warp_sum(loss);
    if (lead) row[0] += loss;
    for (int li = 0; li < nl; ++li)
      for (int k = 0; k < 3; ++k) {
        const float x = warp_sum(d_lp[li][k]);
        if (lead) row[light0 + 3 * li + k] += x;
      }
    __syncthreads();
    for (int c = threadIdx.x; c < ncols; c += kAdjThreads) {
      float acc = 0.0f;
      for (int w = 0; w < kAdjWarps; ++w) acc += rows[w * ncols + c];
      out[c] = acc;
    }
  }
};

// Shared memory of an adjoint kernel's block: the tables, then BlockSums'.
inline size_t adjoint_smem_bytes(const AdjParams& ap) {
  return (table_floats(ap.prm) + kAdjWarps * ap.ncols +
          kAdjWarps * 32 * kRecFloats) *
         sizeof(float);
}

// Chunks of 256 entries over n items.
__host__ __device__ __forceinline__ int adjoint_chunks(int n) {
  return (n + kAdjThreads - 1) / kAdjThreads;
}

// Blocks of an adjoint launch over num_pixels pixels: one a chunk, at least
// one, at most kAdjGridCap (kernels/adjoint_fused.py::adjoint_blocks).
inline int adjoint_blocks(int num_pixels) {
  const int c = adjoint_chunks(num_pixels);
  return c < 1 ? 1 : (c > kAdjGridCap ? kAdjGridCap : c);
}

// Replay adjoint of the bounce chain of one pixel (the JAX
// _adjoint_tile_body, :387-635): L hit levels with topology cst[0..L-1],
// primary direction v from the eye, image cotangent g.  A primal pass keeps
// each level's input ray (o, v) and throughput only; the reverse pass, from
// the last hit level down to 0, re-derives the level's record from its
// (o, v) (the JAX kernel's ov_at route) and applies the node adjoint.  The
// reverse steps are warp-uniform (to the warp's largest L; a lane with
// fewer levels, or none, idles) so that each step's nodes go to sums.add
// together; the light cotangents add into the thread's d_lp.  Every lane
// of the warp must call it.
template <bool WANT_TRANS>
__device__ __forceinline__ void chain_adjoint(const Scene& s,
                                              const Params& prm,
                                              const NodeConst* cst, int L,
                                              float vx, float vy, float vz,
                                              const float g[3],
                                              BlockSums& sums,
                                              float (*d_lp)[3]) {
  // ---- primal pass: each level's input ray and throughput ----
  float O[kMaxLevels][3], V[kMaxLevels][3], T[kMaxLevels][3];
  {
    float ox = prm.eye_x, oy = prm.eye_y, oz = prm.eye_z;
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

  // ---- reverse pass, last hit level down to 0, a level a step ----
  const int steps = __reduce_max_sync(kFullMask, L);
  float pbx = 0.0f, pby = 0.0f, pbz = 0.0f;  // cotangent of the next o
  float vbx = 0.0f, vby = 0.0f, vbz = 0.0f;  // cotangent of the next v
  for (int step = 0; step < steps; ++step) {
    const int lv = L - 1 - step;
    float dsph[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float dmat[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    NodeConst c = {-1, -1, 0u};
    if (lv >= 0) {
      c = cst[lv];
      const bool has_child = lv < prm.depth;
      NodeRec r;
      node_primal(s, c, O[lv][0], O[lv][1], O[lv][2], V[lv][0], V[lv][1],
                  V[lv][2], WANT_TRANS && has_child, &r);
      Cot b = {pbx, pby, pbz, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
               0.0f, 0.0f, 0.0f, 0.0f};
      if (has_child) {
        // v_next = take_t ? t : r (the chain's child select)
        const bool take_t =
            WANT_TRANS && s.mat[c.mid * MAT_COLS + 13] > 0.5f;
        if constexpr (WANT_TRANS) {
          snell_reverse(r, take_t ? vbx : 0.0f, take_t ? vby : 0.0f,
                        take_t ? vbz : 0.0f, &b);
        }
        if (!take_t) { b.rx = vbx; b.ry = vby; b.rz = vbz; }
      }
      const float g3[3] = {T[lv][0] * g[0], T[lv][1] * g[1],
                           T[lv][2] * g[2]};
      node_reverse(s, c, r, g3, b, dsph, dmat, d_lp, &pbx, &pby, &pbz, &vbx,
                   &vby, &vbz);
    }
    sums.add(lv >= 0, c, dsph, dmat);
  }
}

// One node of the tree adjoint's stack: its input ray, weight W (the
// product over its ancestor edges of T on a transmitted edge and 1-T on a
// reflected one), preorder index, level and topology; how many children it
// has visited; and the cotangents its children returned: of their common
// origin (its hit point) and of each child's direction.
struct TreeFrame {
  float o[3], v[3], w[3];
  int idx, level, stage;  // stage: children visited, 0..2
  NodeConst c;
  float ob[3], tb[3], rb[3];
};

// Replay adjoint of the full bounce tree of one pixel (the JAX
// _adjoint_tree_tile_body, :638-793), from the topology records recs[] of
// its 2^(depth+1)-1 preorder nodes (a node that misses holds bik = -1 and
// nothing else is read of it), for depth <= MAX_DEPTH; `live` false runs
// nothing.  The interleaved primal/reverse recursion becomes an explicit
// stack of at most depth+1 frames: a node runs its primal, visits its
// transmitted then its reflected subtree, applies snell_reverse to the
// children's direction cotangents and then its own node_reverse.  A child
// is visited only where its gate (take_t on the transmitted edge, refl_ok
// on the reflected one, both on a hit) is set and it hits: any other child
// adds exactly zero.  Each outer step is warp-uniform (while any lane has a
// frame): a lane descends until one node finishes, and the step's finished
// nodes go to sums.add together, so no node's cotangents are kept.  Every
// lane of the warp must call it.
template <bool WANT_TRANS, int MAX_DEPTH>
__device__ __forceinline__ void tree_adjoint(
    const Scene& s, const Params& prm, const TreeRec* recs, bool live,
    float vx, float vy, float vz, const float g[3], BlockSums& sums,
    float (*d_lp)[3]) {
  const int depth = prm.depth;
  TreeFrame st[MAX_DEPTH + 1];
  int sp = 0;
  if (live && recs[0].bik >= 0) {  // else the primary ray misses: nothing
    TreeFrame& f = st[sp++];
    f.o[0] = prm.eye_x; f.o[1] = prm.eye_y; f.o[2] = prm.eye_z;
    f.v[0] = vx; f.v[1] = vy; f.v[2] = vz;
    f.w[0] = f.w[1] = f.w[2] = 1.0f;
    f.idx = 0; f.level = 0; f.stage = 0;
    f.c = unpack_rec(recs[0]);
    for (int k = 0; k < 3; ++k) f.ob[k] = f.tb[k] = f.rb[k] = 0.0f;
  }
  while (__any_sync(kFullMask, sp > 0)) {
    float dsph[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float dmat[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    NodeConst done = {-1, -1, 0u};
    bool on = false;
    while (sp > 0) {
      TreeFrame& f = st[sp - 1];
      const float* mt = s.mat + f.c.mid * MAT_COLS;
      if (f.level < depth && f.stage < 2) {
        // visit the next child: the transmitted one, then the reflected one
        const bool trans = f.stage == 0;
        ++f.stage;
        if (!(mt[trans ? 13 : 14] > 0.5f)) continue;  // gate 0
        const int cidx =
            trans ? f.idx + 1 : f.idx + (1 << (depth - f.level));
        if (recs[cidx].bik < 0) continue;  // the child misses
        const NodeConst cc = unpack_rec(recs[cidx]);
        NodeRec r;
        node_primal(s, f.c, f.o[0], f.o[1], f.o[2], f.v[0], f.v[1], f.v[2],
                    WANT_TRANS, &r);
        TreeFrame& ch = st[sp++];
        ch.o[0] = r.px; ch.o[1] = r.py; ch.o[2] = r.pz;
        ch.v[0] = trans ? r.tx : r.rx;
        ch.v[1] = trans ? r.ty : r.ry;
        ch.v[2] = trans ? r.tz : r.rz;
        for (int k = 0; k < 3; ++k) {
          ch.w[k] = f.w[k] * (trans ? mt[9 + k] : 1.0f - mt[9 + k]);
          ch.ob[k] = ch.tb[k] = ch.rb[k] = 0.0f;
        }
        ch.idx = cidx; ch.level = f.level + 1; ch.stage = 0;
        ch.c = cc;
        continue;
      }
      // reverse the node, its children's cotangents in hand
      const bool has_child = f.level < depth;
      NodeRec r;
      node_primal(s, f.c, f.o[0], f.o[1], f.o[2], f.v[0], f.v[1], f.v[2],
                  WANT_TRANS && has_child, &r);
      Cot b = {f.ob[0], f.ob[1], f.ob[2], 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
               0.0f, f.rb[0], f.rb[1], f.rb[2], 0.0f};
      if constexpr (WANT_TRANS) {
        if (has_child) snell_reverse(r, f.tb[0], f.tb[1], f.tb[2], &b);
      }
      const float g3[3] = {f.w[0] * g[0], f.w[1] * g[1], f.w[2] * g[2]};
      float ob[3], vb[3];
      node_reverse(s, f.c, r, g3, b, dsph, dmat, d_lp, &ob[0], &ob[1],
                   &ob[2], &vb[0], &vb[1], &vb[2]);
      done = f.c;
      on = true;
      if (--sp > 0) {
        TreeFrame& pa = st[sp - 1];
        float* dir_b = pa.stage == 1 ? pa.tb : pa.rb;
        for (int q = 0; q < 3; ++q) {
          pa.ob[q] += ob[q];
          dir_b[q] = vb[q];
        }
      }
      break;
    }
    sums.add(on, done, dsph, dmat);
  }
}

}  // namespace rtfs
