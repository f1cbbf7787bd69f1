// Device code of the hand-written replay adjoint (adjoint_packed.cu): one
// bounce node's primal record and its reverse sweep, per pixel.  The
// counterparts of the JAX package's kernels/adjoint_fused.py::_node_primal
// (:274-362), _snell_reverse (:365-384) and _node_reverse (:71-262).
//
// A node here is a hit node: the adjoint kernel skips levels at and after a
// lane's miss, whose every term is masked to exactly zero in the JAX code.
// For the same reason the sphere terms of a triangle hit and the triangle
// terms of a sphere hit are not computed (their cotangents are masked to
// zero there), and an unlit light adds nothing.
//
// Rounding.  node_primal evaluates the replay in the plain version's order
// (kernels/adjoint.py::_node_math), operation for operation: IEEE sqrtf, a
// reciprocal by IEEE division where it divides, and, because
// adjoint_packed.cu is built with -fmad=false, no fused multiply-add.  A
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
  float vx, vy, vz, ivl, vlen, ux, uy, uz;
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
  r->vlen = safe_sqrt(vlen2);
  r->ivl = safe_recip(r->vlen);
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
    r->bd = r->m_par * r->vlen;
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
  r->px = ox + r->bd * r->ux;
  r->py = oy + r->bd * r->uy;
  r->pz = oz + r->bd * r->uz;
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

  float ox_b, oy_b, oz_b, vx_b = 0.0f, vy_b = 0.0f, vz_b = 0.0f;
  if (r.is_tri) {
    // n = tn (a constant); p = o + bd*u
    ox_b = b.px; oy_b = b.py; oz_b = b.pz;
    const float bd_b = b.px * r.ux + b.py * r.uy + b.pz * r.uz;
    b.ux += r.bd * b.px; b.uy += r.bd * b.py; b.uz += r.bd * b.pz;
    // bd = m_par * vlen; m_par = (tnv0 - tn.o) / ndv; ndv = tn.v
    const float m_b = bd_b * r.vlen;
    const float vlen_b0 = bd_b * r.m_par;
    const float ndo_b = r.ndv_ok ? -m_b * r.inv_ndv : 0.0f;
    const float ndv_b = -r.m_par * r.inv_ndv * m_b;
    ox_b += ndo_b * r.tnx; oy_b += ndo_b * r.tny; oz_b += ndo_b * r.tnz;
    vx_b = ndv_b * r.tnx; vy_b = ndv_b * r.tny; vz_b = ndv_b * r.tnz;
    // u = v * ivl; vlen = vlen2 * ivl
    vx_b += b.ux * r.ivl; vy_b += b.uy * r.ivl; vz_b += b.uz * r.ivl;
    const float ivl_b = b.ux * r.vx + b.uy * r.vy + b.uz * r.vz;
    const float vlen_b = vlen_b0 - r.ivl * r.ivl * ivl_b;
    const float two_vlen2_b = 2.0f * (0.5f * vlen_b * r.ivl);
    vx_b += two_vlen2_b * r.vx; vy_b += two_vlen2_b * r.vy;
    vz_b += two_vlen2_b * r.vz;
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
    // u = v * ivl; vlen = vlen2 * ivl (vlen feeds only triangle hits)
    vx_b = b.ux * r.ivl; vy_b = b.uy * r.ivl; vz_b = b.uz * r.ivl;
    const float ivl_b = b.ux * r.vx + b.uy * r.vy + b.uz * r.vz;
    const float vlen_b = -r.ivl * r.ivl * ivl_b;
    const float two_vlen2_b = 2.0f * (0.5f * vlen_b * r.ivl);
    vx_b += two_vlen2_b * r.vx; vy_b += two_vlen2_b * r.vy;
    vz_b += two_vlen2_b * r.vz;
  }
  *obx = ox_b; *oby = oy_b; *obz = oz_b;
  *vbx = vx_b; *vby = vy_b; *vbz = vz_b;
}

}  // namespace rtfs
