// Device code shared by the render and fit kernels (render_chain.cu,
// render_tree.cu, adjoint_fused.cu): the per-pixel counterparts of the JAX
// package's kernels/render_pallas.py::_make_tile_ops (intersect_all,
// hit_attrs, mat_attrs, secondary_dirs, shade), _chain_forward and
// _tree_forward.
//
// One thread traces one pixel.  The scene tables (the host's pack_scene
// layouts, kernels/render.py) are copied into dynamic shared memory at block
// start; every thread of a warp reads the same table entry in the sweeps, so
// those reads are broadcasts.  Ids (primitive, material) are ints here; the
// TPU kernel carried them as f32 planes.  Division is IEEE (nvcc's default
// -prec-div=true), where the TPU used an approximate reciprocal plus a
// Newton step.  Every kernel is built with -fmad=false (kernels/
// cuda_build.py): rounded as the plain PyTorch version rounds, the forwards
// pick its hit topology, so the fit kernels' forwards and the render
// kernels' agree bit for bit (PERF.md, PR 3).
//
// The BF16 template flag is RenderConfig.bf16_shading (_make_tile_ops's
// bf16_shading, render_pallas.py:310-371 and :540-555): the any-hit shadow
// sweep (occluded_any) and the Phong blend (shade) multiply and add in
// bfloat16, every compare, reciprocal and square root on an f32 upcast, the
// rest of the node in f32.  Each bf16 operation rounds on its own, as the
// TPU's and PyTorch's bf16 ops do: the __h*_rn intrinsics, which
// cuda_bf16.h documents as never contracted into a fused multiply-add.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rtfs {

// Table layouts, one row per primitive/material/light (kernels/render.py).
constexpr int SPH_COLS = 8;    // cx cy cz r mat valid transp_any -
constexpr int TRI_COLS = 24;   // v0(3) n(3) u(3) v(3) uv uu vv denom ndotv0
                               // mat checker ok transp_any inv_denom - -
constexpr int MAT_COLS = 20;   // amb(3) dif(3) spe(3) trn(3) rho take_trans
                               // refl_ok transp_any - - - -
constexpr int LIGHT_COLS = 8;  // pos(3) color(3) - -
constexpr int MISC_COLS = 16;  // eye(3) board_pos(3) board_half board_sq - -
// Shared-memory-only column: 1/denominator, filled at block start (the
// host table leaves it 0).  The TPU kernel divided on its scalar core.
constexpr int TRI_INV_DEN = 21;

constexpr float BIG = 3.0e38f;

// One hit level of K6's record scratch (RecordWriter), 8 bytes: primitive
// id, material id, lit bits and the level.  Ids stay below 2^15 (the
// tables in shared memory hold a few thousand rows at most), and a record
// holds at most kRecordMaxLights lit bits.
struct __align__(8) NodeRecord {
  short bik, mid;
  unsigned short lits;
  short level;
};
constexpr int kRecordMaxLights = 16;

// Launch-time scalars.  The flat table buffer is
// misc(16) | sph(ns*8) | tri(nt*24) | mat(m*20) | light(nl*8).  The packed
// forward (render_chain.cu, PACKED) also writes pk[depth+1][num_pixels]
// with the field widths bw_bi, bw_mid; the residual forwards (RESIDUALS)
// write the unpacked planes res (ResidualWriter); the record forwards
// (RECORDS, K6's) write rec and rec_n (RecordWriter) and mark the live
// pixels of the L2 cotangent g_scale * mask * (img - target)
// (records_forward); the other kernels leave them unset.
struct Params {
  int ns, nt, m, nl;
  int depth;
  int white_id, black_id;
  float small, atten;
  float eye_x, eye_y, eye_z;
  float* pk;
  float bw_bi, bw_mid;
  float* res;
  NodeRecord* rec;
  int* rec_n;
  const float* target;
  const float* mask;
  float g_scale;
  unsigned* ballots;
  int* counts;
  float* loss_rows;
};

struct Scene {
  const float* sph;
  const float* tri;
  const float* mat;
  const float* light;
  int ns, nt, m, nl;
  float small, atten;
  int white_id, black_id;
  float board_x, board_z, board_half, inv_sq;
};

__host__ __device__ inline int table_floats(const Params& p) {
  return MISC_COLS + p.ns * SPH_COLS + p.nt * TRI_COLS + p.m * MAT_COLS +
         p.nl * LIGHT_COLS;
}

// Copies the tables into shared memory and fills the derived column.
// Every thread of the block must call it (it synchronises).
__device__ inline Scene load_scene(float* smem, const float* __restrict__ tables,
                                   const Params& p) {
  const int n = table_floats(p);
  for (int k = threadIdx.x; k < n; k += blockDim.x) smem[k] = tables[k];
  __syncthreads();
  Scene s;
  const float* misc = smem;
  s.sph = smem + MISC_COLS;
  float* tri = smem + MISC_COLS + p.ns * SPH_COLS;
  s.tri = tri;
  s.mat = s.tri + p.nt * TRI_COLS;
  s.light = s.mat + p.m * MAT_COLS;
  for (int i = threadIdx.x; i < p.nt; i += blockDim.x)
    tri[i * TRI_COLS + TRI_INV_DEN] = 1.0f / tri[i * TRI_COLS + 15];
  __syncthreads();
  s.ns = p.ns; s.nt = p.nt; s.m = p.m; s.nl = p.nl;
  s.small = p.small; s.atten = p.atten;
  s.white_id = p.white_id; s.black_id = p.black_id;
  s.board_x = misc[3]; s.board_z = misc[5];
  s.board_half = misc[6]; s.inv_sq = 1.0f / misc[7];
  return s;
}

// ---- primitive tests (render_pallas.py::intersect_all's tri_hit/sph_hit) --

// Triangle row t against ray o + mm*v: returns the hit predicate (without
// the valid/exclusion gates, which the sweeps fold in) and the parametric
// distance mm along the unnormalized direction.
__device__ __forceinline__ bool tri_hit(const Scene& s, const float* t,
                                        float ox, float oy, float oz,
                                        float vx, float vy, float vz,
                                        float* mm_out) {
  const float ndv = t[3] * vx + t[4] * vy + t[5] * vz;
  const bool plane_ok = fabsf(ndv) >= s.small;
  const float ndo = t[3] * ox + t[4] * oy + t[5] * oz;
  const float mm = (t[16] - ndo) * (1.0f / (plane_ok ? ndv : 1.0f));
  // barycentrics via the precomputed edge dots
  const float px = ox + mm * vx - t[0];
  const float py = oy + mm * vy - t[1];
  const float pz = oz + mm * vz - t[2];
  const float wu = px * t[6] + py * t[7] + pz * t[8];
  const float wv = px * t[9] + py * t[10] + pz * t[11];
  const float inv_den = t[TRI_INV_DEN];
  const float sb = (t[12] * wv - t[14] * wu) * inv_den;
  const float tb = (t[12] * wu - t[13] * wv) * inv_den;
  *mm_out = mm;
  return plane_ok & (mm >= s.small) & (sb >= 0.0f) & (tb >= 0.0f) &
         (sb + tb <= 1.0f);
}

// The gates of triangle row t (id i) in a sweep from origin primitive excl.
__device__ __forceinline__ bool tri_gate(const float* t, int i, int excl) {
  return (t[19] > 0.5f) & (i != excl);
}
// The gates of sphere row c, primitive id `id`.
__device__ __forceinline__ bool sph_gate(const float* c, int id, int excl) {
  return (c[5] > 0.5f) & (id != excl);
}

// Sphere row c against the unit direction u: hit predicate and Euclidean
// distance of the near root only (Shape::intersection :752).
__device__ __forceinline__ bool sph_hit(const Scene& s, const float* c,
                                        float ox, float oy, float oz,
                                        float ux, float uy, float uz,
                                        float* dist_out) {
  const float dx = c[0] - ox, dy = c[1] - oy, dz = c[2] - oz;
  const float ud = ux * dx + uy * dy + uz * dz;
  const float rad = c[3];
  const float disc = ud * ud - (dx * dx + dy * dy + dz * dz) + rad * rad;
  const float dist = disc > 0.0f ? ud - sqrtf(disc) : ud;
  *dist_out = dist;
  return (disc >= 0.0f) & (dist >= s.small);
}

struct Ray {
  float vlen2, inv_vlen, vlen, ux, uy, uz;
  bool ok;
};

__device__ __forceinline__ Ray ray_setup(float vx, float vy, float vz,
                                         bool ray_ok) {
  Ray r;
  r.vlen2 = vx * vx + vy * vy + vz * vz;
  r.ok = ray_ok && r.vlen2 > 0.0f;
  r.inv_vlen = rsqrtf(r.ok ? r.vlen2 : 1.0f);
  r.vlen = r.vlen2 * r.inv_vlen;
  r.ux = vx * r.inv_vlen; r.uy = vy * r.inv_vlen; r.uz = vz * r.inv_vlen;
  return r;
}

// Closest hit over all primitives, triangles first with strict < (the
// reference's insertion-order tie-breaking), excluding the ray's origin
// primitive `excl` (SEMANTICS.md D1).  Primitive ids: triangle i -> i,
// sphere i -> nt + i; -1 on a miss.  With CARRY_TRANSP the winner's
// transparency flag is carried instead of its id (shadow sweeps).
template <bool CARRY_TRANSP>
__device__ __forceinline__ void intersect_closest(
    const Scene& s, float ox, float oy, float oz, float vx, float vy,
    float vz, int excl, const Ray& r, float* bd_out, int* bi_out,
    float* transp_out) {
  float bd = BIG;
  int bi = -1;
  float transp = 0.0f;
  if (r.ok) {
    // the gates fold into the compare as predicates, not branches
    for (int i = 0; i < s.nt; ++i) {
      const float* t = s.tri + i * TRI_COLS;
      float mm;
      const bool h = tri_hit(s, t, ox, oy, oz, vx, vy, vz, &mm);
      const float dist = mm * r.vlen;
      const bool take = h & tri_gate(t, i, excl) & (dist < bd);
      bd = take ? dist : bd;
      bi = take ? i : bi;
      if constexpr (CARRY_TRANSP) transp = take ? t[20] : transp;
    }
    for (int i = 0; i < s.ns; ++i) {
      const float* c = s.sph + i * SPH_COLS;
      float dist;
      const bool h = sph_hit(s, c, ox, oy, oz, r.ux, r.uy, r.uz, &dist);
      const bool take = h & sph_gate(c, s.nt + i, excl) & (dist < bd);
      bd = take ? dist : bd;
      bi = take ? s.nt + i : bi;
      if constexpr (CARRY_TRANSP) transp = take ? c[6] : transp;
    }
  }
  *bd_out = bd;
  *bi_out = bi;
  if constexpr (CARRY_TRANSP) *transp_out = transp;
}

// ---- the bf16 forms (render_pallas.py:310-371, :540-555) -----------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ bf16 to_bf16(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 bmul(bf16 a, bf16 b) { return __hmul_rn(a, b); }
__device__ __forceinline__ bf16 badd(bf16 a, bf16 b) { return __hadd_rn(a, b); }
__device__ __forceinline__ bf16 bsub(bf16 a, bf16 b) { return __hsub_rn(a, b); }
// a.b over three components, left to right: (ax*bx + ay*by) + az*bz
__device__ __forceinline__ bf16 bdot(bf16 ax, bf16 ay, bf16 az, bf16 bx,
                                     bf16 by, bf16 bz) {
  return badd(badd(bmul(ax, bx), bmul(ay, by)), bmul(az, bz));
}

// A ray cast to bf16 once per shadow sweep: origin, direction, unit
// direction.
struct RayBf16 {
  bf16 ox, oy, oz, vx, vy, vz, ux, uy, uz;
};

// tri_hit with the dot products, hit point and barycentrics in bf16 (each
// table scalar cast on its own); mm and every compare in f32.
__device__ __forceinline__ bool tri_hit_bf16(const Scene& s, const float* t,
                                             const RayBf16& b) {
  const bf16 nx = to_bf16(t[3]), ny = to_bf16(t[4]), nz = to_bf16(t[5]);
  const float ndv = to_f32(bdot(nx, ny, nz, b.vx, b.vy, b.vz));
  const bool plane_ok = fabsf(ndv) >= s.small;
  const float ndo = to_f32(bdot(nx, ny, nz, b.ox, b.oy, b.oz));
  const float mm = (t[16] - ndo) * (1.0f / (plane_ok ? ndv : 1.0f));
  const bf16 mmb = to_bf16(mm);
  const bf16 px = bsub(badd(b.ox, bmul(mmb, b.vx)), to_bf16(t[0]));
  const bf16 py = bsub(badd(b.oy, bmul(mmb, b.vy)), to_bf16(t[1]));
  const bf16 pz = bsub(badd(b.oz, bmul(mmb, b.vz)), to_bf16(t[2]));
  const bf16 wu = bdot(px, py, pz, to_bf16(t[6]), to_bf16(t[7]),
                       to_bf16(t[8]));
  const bf16 wv = bdot(px, py, pz, to_bf16(t[9]), to_bf16(t[10]),
                       to_bf16(t[11]));
  const bf16 uv = to_bf16(t[12]), uu = to_bf16(t[13]), vv = to_bf16(t[14]);
  const bf16 inv_den = to_bf16(t[TRI_INV_DEN]);
  const float sb = to_f32(bmul(bsub(bmul(uv, wv), bmul(vv, wu)), inv_den));
  const float tb = to_f32(bmul(bsub(bmul(uv, wu), bmul(uu, wv)), inv_den));
  return plane_ok & (mm >= s.small) & (sb >= 0.0f) & (tb >= 0.0f) &
         (sb + tb <= 1.0f);
}

// sph_hit with the centre offsets and dot products in bf16; disc around
// them, the root and the compares in f32.
__device__ __forceinline__ bool sph_hit_bf16(const Scene& s, const float* c,
                                             const RayBf16& b) {
  const bf16 dx = bsub(to_bf16(c[0]), b.ox);
  const bf16 dy = bsub(to_bf16(c[1]), b.oy);
  const bf16 dz = bsub(to_bf16(c[2]), b.oz);
  const float ud = to_f32(bdot(b.ux, b.uy, b.uz, dx, dy, dz));
  const float disc = ud * ud - to_f32(bdot(dx, dy, dz, dx, dy, dz)) +
                     c[3] * c[3];
  const float dist = disc > 0.0f ? ud - sqrtf(disc) : ud;
  return (disc >= 0.0f) & (dist >= s.small);
}

// Any-hit occlusion: valid only when no material is transparent, where
// "lit = nearest occluder missing or transparent" (MySdlApplication.cpp:1221)
// degenerates to "lit = no occluder".  Stops at the first occluder.  BF16
// tests the primitives in their bf16 forms.
template <bool BF16>
__device__ __forceinline__ bool occluded_any(const Scene& s, float ox,
                                             float oy, float oz, float vx,
                                             float vy, float vz, int excl,
                                             const Ray& r) {
  if (!r.ok) return false;
  RayBf16 b;
  if constexpr (BF16) {
    b = RayBf16{to_bf16(ox), to_bf16(oy), to_bf16(oz),
                to_bf16(vx), to_bf16(vy), to_bf16(vz),
                to_bf16(r.ux), to_bf16(r.uy), to_bf16(r.uz)};
  }
  for (int i = 0; i < s.nt; ++i) {
    const float* t = s.tri + i * TRI_COLS;
    bool h;
    if constexpr (BF16) {
      h = tri_hit_bf16(s, t, b);
    } else {
      float mm;
      h = tri_hit(s, t, ox, oy, oz, vx, vy, vz, &mm);
    }
    if (h & tri_gate(t, i, excl)) return true;
  }
  for (int i = 0; i < s.ns; ++i) {
    const float* c = s.sph + i * SPH_COLS;
    bool h;
    if constexpr (BF16) {
      h = sph_hit_bf16(s, c, b);
    } else {
      float dist;
      h = sph_hit(s, c, ox, oy, oz, r.ux, r.uy, r.uz, &dist);
    }
    if (h & sph_gate(c, s.nt + i, excl)) return true;
  }
  return false;
}

// ---- hit attributes (render_pallas.py::hit_attrs) -------------------------

struct Surf {
  float px, py, pz, nx, ny, nz;
  int mid;
};

// The TPU blended attributes over every primitive by mask; here the winner's
// row is loaded directly.  On a miss (bi = -1) the result is what the blend
// gives: is_tri is true, the normal is zero, mid is 0 (no checker override).
// A triangle's point is o + mm*v, as the core and the oracle form it
// (ops/intersect.py), with the winner's mm recomputed from its row in
// tri_hit's order, so it equals the sweep's bit for bit and the sweep keeps
// no extra register.  Formed as o + bd*u (bd = mm*|v|, u = v*rsqrt(|v|^2))
// it rounds off the plane, and a ray that meets the board on a checker
// edge (the look-at point of an even-height frame) lands in the
// neighbouring square.  A sphere's point is o + bd*u.
__device__ __forceinline__ Surf hit_attrs(const Scene& s, float bd, int bi,
                                          bool hitm, float ox, float oy,
                                          float oz, float vx, float vy,
                                          float vz, const Ray& r) {
  float tnx = 0.0f, tny = 0.0f, tnz = 0.0f, tchk = 0.0f, mm = 0.0f;
  float scx = 0.0f, scy = 0.0f, scz = 0.0f;
  int tmid = 0, smid = 0;
  if (bi >= 0 && bi < s.nt) {
    const float* t = s.tri + bi * TRI_COLS;
    tnx = t[3]; tny = t[4]; tnz = t[5];
    tmid = static_cast<int>(t[17]);
    tchk = t[18];
    // the winner passed tri_hit's plane test, so its ndv is the divisor
    const float ndv = t[3] * vx + t[4] * vy + t[5] * vz;
    const float ndo = t[3] * ox + t[4] * oy + t[5] * oz;
    mm = (t[16] - ndo) * (1.0f / ndv);
  } else if (bi >= s.nt) {
    const float* c = s.sph + (bi - s.nt) * SPH_COLS;
    scx = c[0]; scy = c[1]; scz = c[2];
    smid = static_cast<int>(c[4]);
  }
  const bool is_tri = bi < s.nt;
  Surf f;
  const float k = hitm ? (is_tri ? mm : bd) : 0.0f;
  f.px = ox + k * (is_tri ? vx : r.ux);
  f.py = oy + k * (is_tri ? vy : r.uy);
  f.pz = oz + k * (is_tri ? vz : r.uz);
  const float d0x = f.px - scx, d0y = f.py - scy, d0z = f.pz - scz;
  const float d0sq = d0x * d0x + d0y * d0y + d0z * d0z;
  const float inv_d0 = rsqrtf(d0sq > 0.0f ? d0sq : 1.0f);
  f.nx = hitm ? (is_tri ? tnx : d0x * inv_d0) : 0.0f;
  f.ny = hitm ? (is_tri ? tny : d0y * inv_d0) : 0.0f;
  f.nz = hitm ? (is_tri ? tnz : d0z * inv_d0) : 0.0f;
  int mid = is_tri ? tmid : smid;
  // checkerboard override: square parity with C truncation (:1101-1111),
  // trunc(s/2)*2 == s on the exact small integer s
  const float fx = truncf((f.px - s.board_x + s.board_half) * s.inv_sq);
  const float fz = truncf((f.pz - s.board_z + s.board_half) * s.inv_sq);
  const float s_par = fx + fz;
  const bool parity_even = truncf(s_par * 0.5f) * 2.0f == s_par;
  if (is_tri && tchk > 0.5f) mid = parity_even ? s.white_id : s.black_id;
  f.mid = mid;
  return f;
}

// ---- secondary directions (render_pallas.py::secondary_dirs) --------------

struct Dirs {
  float rx, ry, rz, tx, ty, tz;
};

// Reflected and transmitted (Snell, TIR-guarded) unit-scale directions.
// Without a transmitting material the Snell branch is skipped and the
// transmitted direction is zero (the chain never takes it).
template <bool WANT_TRANS>
__device__ __forceinline__ Dirs secondary_dirs(const Ray& r, const Surf& f,
                                               float rho) {
  Dirs d;
  const float cosi = r.ux * f.nx + r.uy * f.ny + r.uz * f.nz;
  d.rx = r.ux - 2.0f * cosi * f.nx;
  d.ry = r.uy - 2.0f * cosi * f.ny;
  d.rz = r.uz - 2.0f * cosi * f.nz;
  if constexpr (!WANT_TRANS) {
    d.tx = d.ty = d.tz = 0.0f;
    return d;
  }
  const float modulus = 1.0f - rho * rho * (1.0f - cosi * cosi);
  const bool mod_ok = modulus > 0.0f;
  const float mod_f = mod_ok ? 1.0f : 0.0f;
  const float cosr = mod_ok ? sqrtf(modulus) : 0.0f;
  const float coef = cosr + rho * cosi;
  d.tx = (rho * r.ux - coef * f.nx) * mod_f;
  d.ty = (rho * r.uy - coef * f.ny) * mod_f;
  d.tz = (rho * r.uz - coef * f.nz) * mod_f;
  return d;
}

// ---- shading (render_pallas.py::shade) ------------------------------------

// Per-light shadow ray plus Phong accumulation (MySdlApplication.cpp
// :1213-1228) into col, weighted by the throughput thr.  ALL_OPAQUE (no
// transparent material) selects the any-hit shadow sweep; otherwise the
// nearest occluder's transparency flag decides (in f32 with BF16 too).
// BF16 blends in bf16: the light colour folds into w in f32, then
// thr * (w*L) * (amb + ndots*dif + udotr*spe) in bf16, added to the f32 col.
// Returns the shadow sweeps' booleans as bits (bit li: light li lit),
// before the hitm mask.
template <bool ALL_OPAQUE, bool BF16>
__device__ __forceinline__ unsigned shade(const Scene& s, const Surf& f,
                                          int bi, bool hitm, const Ray& r,
                                          const Dirs& d, const float* mt,
                                          const float thr[3], float col[3]) {
  unsigned lit_bits = 0u;
  for (int li = 0; li < s.nl; ++li) {
    const float* L = s.light + li * LIGHT_COLS;
    const float svx = L[0] - f.px, svy = L[1] - f.py, svz = L[2] - f.pz;
    const Ray sr = ray_setup(svx, svy, svz, hitm);
    bool lit;
    if constexpr (ALL_OPAQUE) {
      lit = !occluded_any<BF16>(s, f.px, f.py, f.pz, svx, svy, svz, bi,
                                sr);
    } else {
      float sd, transp;
      int sbi;
      intersect_closest<true>(s, f.px, f.py, f.pz, svx, svy, svz, bi, sr,
                              &sd, &sbi, &transp);
      lit = sd >= BIG || transp > 0.5f;
    }
    if (lit) lit_bits |= 1u << li;
    const float d2 = svx * svx + svy * svy + svz * svz;
    const float att = s.atten / (s.atten + d2);
    const float inv_sl = rsqrtf(d2 > 0.0f ? d2 : 1.0f);
    const float ndots = fabsf(f.nx * svx + f.ny * svy + f.nz * svz) * inv_sl;
    const float udotr = fabsf(r.ux * d.rx + r.uy * d.ry + r.uz * d.rz);
    const float w = (lit && hitm) ? att : 0.0f;
    if constexpr (BF16) {
      const bf16 nb = to_bf16(ndots), ub = to_bf16(udotr);
      for (int ch = 0; ch < 3; ++ch) {
        const bf16 blend =
            badd(badd(to_bf16(mt[ch]), bmul(nb, to_bf16(mt[3 + ch]))),
                 bmul(ub, to_bf16(mt[6 + ch])));
        col[ch] += to_f32(bmul(bmul(to_bf16(thr[ch]), to_bf16(w * L[3 + ch])),
                               blend));
      }
    } else {
      col[0] += thr[0] * w * (mt[0] + ndots * mt[3] + udotr * mt[6]) * L[3];
      col[1] += thr[1] * w * (mt[1] + ndots * mt[4] + udotr * mt[7]) * L[4];
      col[2] += thr[2] * w * (mt[2] + ndots * mt[5] + udotr * mt[8]) * L[5];
    }
  }
  return lit_bits;
}

// One bounce node shared by both kernels: closest hit of ray (o, v), and on
// a hit its surface, material row and secondary directions, with the node's
// own shading added to col and its lit bits in *lit_bits.  Returns false on
// a miss, whose contribution (and whole subtree's) is exactly zero.
template <bool WANT_TRANS, bool BF16>
__device__ __forceinline__ bool trace_node(const Scene& s, float ox, float oy,
                                           float oz, float vx, float vy,
                                           float vz, int excl,
                                           const float thr[3], float col[3],
                                           Surf* f, int* bi, const float** mt,
                                           Dirs* d, unsigned* lit_bits) {
  const Ray r = ray_setup(vx, vy, vz, true);
  float bd;
  intersect_closest<false>(s, ox, oy, oz, vx, vy, vz, excl, r, &bd, bi,
                           nullptr);
  const bool hitm = bd < BIG;
  if (!hitm) return false;
  *f = hit_attrs(s, bd, *bi, hitm, ox, oy, oz, vx, vy, vz, r);
  *mt = s.mat + f->mid * MAT_COLS;
  *d = secondary_dirs<WANT_TRANS>(r, *f, (*mt)[12]);
  *lit_bits =
      shade<!WANT_TRANS, BF16>(s, *f, *bi, hitm, r, *d, *mt, thr, col);
  return true;
}

// ---- the chain and the tree (render_pallas.py::_chain_forward,
// _tree_forward) ----------------------------------------------------------

// Deepest tree the per-thread stacks hold (kernels/render.py::TREE_MAX_DEPTH).
constexpr int kTreeMaxDepth = 10;

// The bounce chain of one pixel, primary direction v from the eye: adds each
// level's shading to col and calls sink(level, bi, mid, lit_bits) at each
// level that hits.  The chain ends at a miss, and after a level whose chosen
// child is not traced.  Returns the number of levels hit.
template <bool WANT_TRANS, bool BF16, typename Sink>
__device__ __forceinline__ int chain_forward(const Scene& s, const Params& prm,
                                             float vx, float vy, float vz,
                                             float col[3], Sink&& sink) {
  float ox = prm.eye_x, oy = prm.eye_y, oz = prm.eye_z;
  float thr[3] = {1.0f, 1.0f, 1.0f};
  int excl = -1;
  int level = 0;
  for (; level <= prm.depth; ++level) {
    Surf f;
    int bi;
    const float* mt;
    Dirs d;
    unsigned lit_bits;
    if (!trace_node<WANT_TRANS, BF16>(s, ox, oy, oz, vx, vy, vz, excl, thr,
                                      col, &f, &bi, &mt, &d, &lit_bits))
      break;  // a miss adds zero from here on
    sink(level, bi, f.mid, lit_bits);
    // child ray selection (chain-exact): transmitted if traced, else
    // reflected if the material is not fully transparent
    const bool take_t = mt[13] > 0.5f;
    vx = take_t ? d.tx : d.rx;
    vy = take_t ? d.ty : d.ry;
    vz = take_t ? d.tz : d.rz;
    thr[0] *= take_t ? mt[9] : 1.0f - mt[9];
    thr[1] *= take_t ? mt[10] : 1.0f - mt[10];
    thr[2] *= take_t ? mt[11] : 1.0f - mt[11];
    const bool branch =
        take_t ? (vx * vx + vy * vy + vz * vz > 0.0f) : (mt[14] > 0.5f);
    if (!branch) return level + 1;  // the next levels are dead
    ox = f.px; oy = f.py; oz = f.pz;
    excl = bi;
  }
  return level;
}

struct TreeNode {
  float ox, oy, oz, vx, vy, vz;
  float thr[3];
  int excl;       // the origin primitive
  int level_idx;  // level << 16 | the node's preorder index
};

// The full bounce tree of one pixel (MySdlApplication.cpp:1230-1248): at
// every hit a transmitted child weighted by the transparency T and a
// reflected child weighted by the opacity 1-T, down to prm.depth.  The
// recursion is a loop that descends into a node's transmitted child at
// once and keeps its reflected child on a per-thread stack of at most
// depth entries, so the nodes are visited in preorder (transmitted subtree
// first) and the colour sums in the JAX kernel's order.  Calls sink(idx,
// bi, mid, lit_bits) at each node that hits, idx its preorder index among
// the 2^(depth+1)-1 nodes: the transmitted child of node idx at level l is
// idx+1, the reflected one idx+2^(depth-l).  A node that misses, or a child
// whose weight gate is 0, adds exactly zero and is not visited.
template <bool WANT_TRANS, bool BF16, typename Sink>
__device__ __forceinline__ void tree_forward(const Scene& s, const Params& prm,
                                             float vx, float vy, float vz,
                                             float col[3], Sink&& sink) {
  TreeNode stack[kTreeMaxDepth];
  int sp = 0;
  TreeNode nd{prm.eye_x, prm.eye_y, prm.eye_z, vx, vy, vz,
              {1.0f, 1.0f, 1.0f}, -1, 0};
  for (;;) {
    Surf f;
    int bi;
    const float* mt;
    Dirs d;
    unsigned lit_bits;
    bool descend = false;
    if (trace_node<WANT_TRANS, BF16>(s, nd.ox, nd.oy, nd.oz, nd.vx, nd.vy,
                                     nd.vz, nd.excl, nd.thr, col, &f, &bi,
                                     &mt, &d, &lit_bits)) {
      const int level = nd.level_idx >> 16, idx = nd.level_idx & 0xffff;
      sink(idx, bi, f.mid, lit_bits);
      if (level < prm.depth) {
        // gates of the transmitted (T != 0 and |T| > SMALL, :1238) and
        // reflected (opacity != 0, :1243) children; the reflected one
        // waits on the stack while the transmitted subtree is visited
        const float take_f = mt[13];
        const float refl_f = mt[14];
        if (refl_f != 0.0f) {
          stack[sp++] = TreeNode{
              f.px, f.py, f.pz, d.rx * refl_f, d.ry * refl_f, d.rz * refl_f,
              {nd.thr[0] * (1.0f - mt[9]) * refl_f,
               nd.thr[1] * (1.0f - mt[10]) * refl_f,
               nd.thr[2] * (1.0f - mt[11]) * refl_f},
              bi, ((level + 1) << 16) | (idx + (1 << (prm.depth - level)))};
        }
        if (take_f != 0.0f) {
          nd = TreeNode{f.px, f.py, f.pz,
                        d.tx * take_f, d.ty * take_f, d.tz * take_f,
                        {nd.thr[0] * mt[9] * take_f,
                         nd.thr[1] * mt[10] * take_f,
                         nd.thr[2] * mt[11] * take_f},
                        bi, ((level + 1) << 16) | (idx + 1)};
          descend = true;
        }
      }
    }
    if (!descend) {  // a miss zeroes both children
      if (sp == 0) break;
      nd = stack[--sp];
    }
  }
}

// Most lights the residual forwards hold: the lit flags come from the
// shadow sweep's 32-bit word (kernels/render.py::RESIDUAL_MAX_LIGHTS).
constexpr int kResidualMaxLights = 32;

// One pixel's unpacked residual planes, prm.res as f32 [2+nl][K][P]: plane
// 0 the hit primitive id (-1 where the node misses or is not traced), 1 the
// resolved material id, 2+li light li's lit flag (0/1), for the K chain
// levels or preorder tree nodes; the layout of kernels/render.py::
// render_residuals_ref.  Nodes are handed over in increasing order (a
// chain's levels, a tree's preorder visits): each gap, and the tail after
// the last, takes the value a dead TPU lane stores (bi = -1, mid = 0, every
// lit flag 1), so every element is written once.  Neighbouring threads
// write neighbouring addresses.
struct ResidualWriter {
  float* res;  // prm.res
  size_t kp;   // K * num_pixels: the stride between planes
  int num_pixels, p, nl, next;

  __device__ ResidualWriter(const Params& prm, int K, int num_pixels, int p)
      : res(prm.res), kp(static_cast<size_t>(K) * num_pixels),
        num_pixels(num_pixels), p(p), nl(prm.nl), next(0) {}

  __device__ void store(int k, int bi, int mid, unsigned lit_bits) {
    float* r = res + static_cast<size_t>(k) * num_pixels + p;
    r[0] = static_cast<float>(bi);
    r[kp] = static_cast<float>(mid);
    for (int li = 0; li < nl; ++li)
      r[(2 + li) * kp] = ((lit_bits >> li) & 1u) ? 1.0f : 0.0f;
  }
  // dead values for the nodes before k
  __device__ void fill_to(int k) {
    for (; next < k; ++next) store(next, -1, 0, 0xffffffffu);
  }
  // node k hit: the gap before it, then its own values
  __device__ void hit(int k, int bi, int mid, unsigned lit_bits) {
    fill_to(k);
    store(k, bi, mid, lit_bits);
    next = k + 1;
  }
};

// The record sink of K6's chain forward (render_chain.cu's RECORDS form):
// pixel p's hit level n goes to prm.rec[n * num_pixels + p] ([depth+1][P]
// NodeRecords, neighbouring threads on neighbouring addresses); n counts
// them, and a live pixel writes the count to prm.rec_n[p]
// (records_forward).  Only the levels that hit are written: the adjoint
// reads a live pixel's first rec_n[p] records.
struct RecordWriter {
  NodeRecord* rec;  // prm.rec
  int num_pixels, p, n;

  __device__ RecordWriter(const Params& prm, int num_pixels, int p)
      : rec(prm.rec), num_pixels(num_pixels), p(p), n(0) {}

  __device__ void hit(int level, int bi, int mid, unsigned lit_bits) {
    rec[static_cast<size_t>(n) * num_pixels + p] =
        NodeRecord{static_cast<short>(bi), static_cast<short>(mid),
                   static_cast<unsigned short>(lit_bits),
                   static_cast<short>(level)};
    ++n;
  }
};

// ---- the live list's mark (adjoint_packed.cu::rtfs_live_list) -----------

constexpr unsigned kFullMask = 0xffffffffu;

// Sum over the 32 lanes; every lane gets the same, order-fixed value.
__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

// Pixel p's squared-error term, added to *loss, and whether its L2
// cotangent g_scale * (mask * (img - target)) is nonzero, or'ed into
// *live (K4's prologue): img is its image, mk its mask.
__device__ __forceinline__ void l2_term(const float img[3],
                                        const float* __restrict__ target,
                                        float mk, float g_scale, int p,
                                        float* loss, bool* live) {
  for (int ch = 0; ch < 3; ++ch) {
    const float d_raw = img[ch] - target[3 * p + ch];
    const float d = d_raw * mk;
    *loss += d * d_raw;
    *live = *live || g_scale * d != 0.0f;
  }
}

// A block's marks for the live list, in shared memory: each warp's count
// of live pixels and loss sum, and how many warps have marked.  Thread 0
// zeroes `arrived` before the block's first __syncthreads.
struct BlockMarks {
  static constexpr int kWarps = 256 / 32;
  int wcount[kWarps];
  float wloss[kWarps];
  int arrived;
};

// Marks a warp of a block of 256 pixels for the live list: the ballot of
// its live pixels (ballots[block * 8 + warp]); the block's last warp to
// mark (an integer count in shared memory: no warp waits for the others,
// whose work per pixel differs) writes the block's count of live pixels
// and, where loss_rows is given, the sum of its threads' loss terms in a
// fixed order: a butterfly over each warp, then the warps in order.
// Every thread of the block must call it.
__device__ inline void mark_live(BlockMarks& marks, bool live, float loss,
                                 unsigned* __restrict__ ballots,
                                 int* __restrict__ counts,
                                 float* __restrict__ loss_rows) {
  constexpr int kWarps = BlockMarks::kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned b = __ballot_sync(kFullMask, live);
  loss = warp_sum(loss);
  if (lane != 0) return;
  ballots[blockIdx.x * kWarps + warp] = b;
  marks.wcount[warp] = __popc(b);
  marks.wloss[warp] = loss;
  __threadfence_block();
  if (atomicAdd(&marks.arrived, 1) != kWarps - 1) return;
  __threadfence_block();
  const volatile BlockMarks& m = marks;
  int c = 0;
  float l = 0.0f;
  for (int w = 0; w < kWarps; ++w) {
    c += m.wcount[w];
    l += m.wloss[w];
  }
  counts[blockIdx.x] = c;
  if (loss_rows != nullptr) loss_rows[blockIdx.x] = l;
}

// K6's chain forward (render_chain.cu's RECORDS form): per pixel the
// records of its levels that hit (`trace(p, col, rw)` traces pixel p into
// col, hands each hit to the RecordWriter rw and returns their count) and,
// for the live list, the block's marks (every thread marks; a pixel past
// the frame is not live).  Only a live pixel writes its image and its
// count: the adjoint reads no other's.
template <typename Trace>
__device__ __forceinline__ void records_forward(const Params& prm,
                                                float* __restrict__ out,
                                                int num_pixels,
                                                BlockMarks& marks,
                                                Trace&& trace) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  float loss = 0.0f;
  bool live = false;
  if (p < num_pixels) {
    float col[3] = {0.0f, 0.0f, 0.0f};
    RecordWriter rw(prm, num_pixels, p);
    const int n = trace(p, col, rw);
    l2_term(col, prm.target, prm.mask[p], prm.g_scale, p, &loss, &live);
    if (live) {
      out[3 * p] = col[0];
      out[3 * p + 1] = col[1];
      out[3 * p + 2] = col[2];
      prm.rec_n[p] = n;
    }
  }
  mark_live(marks, live, loss, prm.ballots, prm.counts, prm.loss_rows);
}

// The signature both render kernels share.
using RenderKernel = void (*)(const float*, Params, const float*, float*,
                              int);

// Launches `kernel` with one thread per pixel, 256 a block (at least one
// block: the records form marks an empty frame too), and the tables in
// dynamic shared memory (raising the 48 KB default limit when they need
// more).  Returns the launch's cudaError_t.
inline cudaError_t launch_render(RenderKernel kernel, const float* tables,
                                 const Params& prm, const float* v, float* out,
                                 int num_pixels, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const size_t smem = table_floats(prm) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (num_pixels + kThreads - 1) / kThreads;
  kernel<<<blocks > 0 ? blocks : 1, kThreads, smem, stream>>>(tables, prm, v,
                                                              out, num_pixels);
  return cudaGetLastError();
}

// Blocks of 256 threads of `kernel` one SM holds at once with `smem_bytes`
// of dynamic shared memory, into *blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns its cudaError_t.
template <typename Kernel>
inline cudaError_t kernel_occupancy(Kernel kernel, int smem_bytes,
                                    int* blocks) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, 256, static_cast<size_t>(smem_bytes));
}

}  // namespace rtfs
