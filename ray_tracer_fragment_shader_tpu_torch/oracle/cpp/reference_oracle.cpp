// C++ CPU oracle renderer: a float64, per-ray recursive implementation of
// the reference ray tracer's semantics (Hw4/MySdlApplication.cpp), used as a
// bit-level test oracle for the renderers (the port's copy of the JAX
// package's source; oracle/native.py builds it under _build/).  Original
// implementation against the semantics documented in SEMANTICS.md — shares
// only the FlatScene data layout with the Python side.
//
// Call stack mirrors the reference: render() -> trace_ray() (rayTraceRay,
// :1184-1249) -> closest_hit() (Shape::intersection flattened, :724-823).
//
// Build: g++ -O2 -shared -fPIC -o <library>.so reference_oracle.cpp

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct Vec3 {
  double x, y, z;
};

inline Vec3 v3(double x, double y, double z) { return Vec3{x, y, z}; }
inline Vec3 operator+(Vec3 a, Vec3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
inline Vec3 operator-(Vec3 a, Vec3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
inline Vec3 operator*(double s, Vec3 a) { return v3(s * a.x, s * a.y, s * a.z); }
inline Vec3 hadamard(Vec3 a, Vec3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
inline double dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline Vec3 cross(Vec3 a, Vec3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
inline double norm(Vec3 a) { return std::sqrt(dot(a, a)); }
inline Vec3 normalized(Vec3 a) {
  double n = norm(a);
  return n > 0 ? (1.0 / n) * a : v3(0, 0, 0);
}

// Table row widths (must match oracle/native.py)
constexpr int SPH_W = 8;    // cx cy cz r mat group - -
constexpr int TRI_W = 16;   // v0(3) v1(3) v2(3) mat checker group - - - -
constexpr int MAT_W = 16;   // amb(3) dif(3) spe(3) trn(3) rho - - -
constexpr int LIGHT_W = 8;  // pos(3) color(3) - -
constexpr int GRP_W = 4;    // cx cy cz r

struct Scene {
  const double* sph; int ns;
  const double* tri; int nt;
  const double* mat; int nm;
  const double* light; int nl;
  const double* grp; int ng;
  Vec3 board_pos; double board_half, board_square;
  int white_id, black_id;
  double small, atten;
  bool prune;
  // precomputed per-triangle quantities (Triangle ctor, :406-433)
  double* tn;     // [nt*3] unit plane normal
  double* tu;     // [nt*3] edge u
  double* tv;     // [nt*3] edge v
  double* tdots;  // [nt*4] uv uu vv denominator
  bool* tdeg;
};

struct Hit {
  bool ok = false;
  Vec3 p, n;
  int mat = 0;
  Vec3 refl, trans;
};

Vec3 mat_col(const Scene& s, int m, int off) {
  const double* r = s.mat + m * MAT_W + off;
  return v3(r[0], r[1], r[2]);
}

// Shape::intersection flattened: strict-< nearest, triangles before spheres
// (scene insertion order), hierarchical bounding-sphere prune.
bool closest_hit(const Scene& s, Vec3 o, Vec3 v, int exclude, Hit* out,
                 int* prim_id) {
  double vlen = norm(v);
  if (!(vlen > 0) || !std::isfinite(vlen)) return false;
  Vec3 u = (1.0 / vlen) * v;

  bool pruned[64] = {false};
  if (s.prune) {
    for (int g = 0; g < s.ng && g < 64; g++) {
      double r = s.grp[g * GRP_W + 3];
      if (r <= 0) continue;
      Vec3 c = v3(s.grp[g * GRP_W], s.grp[g * GRP_W + 1], s.grp[g * GRP_W + 2]);
      Vec3 d = c - o;
      double ud = dot(u, d);
      double disc = ud * ud - dot(d, d) + r * r;
      // reject on disc<0 || |s|<eps (:749-758)
      pruned[g] = disc < 0 || std::fabs(ud - std::sqrt(disc)) < s.small;
    }
  }

  double best = -1.0;
  Hit h;
  int best_id = -1;

  for (int i = 0; i < s.nt; i++) {
    if (s.tdeg[i] || i == exclude) continue;
    int g = static_cast<int>(s.tri[i * TRI_W + 11]);
    if (s.prune && g < 64 && pruned[g]) continue;
    Vec3 n = v3(s.tn[i * 3], s.tn[i * 3 + 1], s.tn[i * 3 + 2]);
    double ndv = dot(n, v);
    if (std::fabs(ndv) < s.small) continue;
    Vec3 v0 = v3(s.tri[i * TRI_W], s.tri[i * TRI_W + 1], s.tri[i * TRI_W + 2]);
    double m = dot(n, v0 - o) / ndv;
    if (m < s.small) continue;
    Vec3 p = o + m * v;
    Vec3 w = p - v0;
    Vec3 eu = v3(s.tu[i * 3], s.tu[i * 3 + 1], s.tu[i * 3 + 2]);
    Vec3 ev = v3(s.tv[i * 3], s.tv[i * 3 + 1], s.tv[i * 3 + 2]);
    double wu = dot(w, eu), wv = dot(w, ev);
    double uv = s.tdots[i * 4], uu = s.tdots[i * 4 + 1];
    double vv = s.tdots[i * 4 + 2], den = s.tdots[i * 4 + 3];
    double sb = (uv * wv - vv * wu) / den;
    double tb = (uv * wu - uu * wv) / den;
    if (!(sb >= 0 && tb >= 0 && sb + tb <= 1)) continue;
    double dist = norm(p - o);
    if (best < 0 || dist < best) {
      best = dist;
      best_id = i;
      h.ok = true; h.p = p; h.n = n;
      h.mat = static_cast<int>(s.tri[i * TRI_W + 9]);
      if (s.tri[i * TRI_W + 10] > 0.5) {  // checker override (:1084-1113)
        double px = p.x - s.board_pos.x + s.board_half;
        double pz = p.z - s.board_pos.z + s.board_half;
        int sq = static_cast<int>(px / s.board_square) +
                 static_cast<int>(pz / s.board_square);
        h.mat = (sq & 1) == 0 ? s.white_id : s.black_id;
      }
    }
  }

  for (int i = 0; i < s.ns; i++) {
    int id = s.nt + i;
    if (id == exclude) continue;
    int g = static_cast<int>(s.sph[i * SPH_W + 5]);
    if (s.prune && g < 64 && pruned[g]) continue;
    Vec3 c = v3(s.sph[i * SPH_W], s.sph[i * SPH_W + 1], s.sph[i * SPH_W + 2]);
    double r = s.sph[i * SPH_W + 3];
    Vec3 d = c - o;
    double ud = dot(u, d);
    double disc = ud * ud - dot(d, d) + r * r;
    if (disc < 0) continue;
    double sr = ud - std::sqrt(disc);  // near root only (:752)
    if (std::fabs(sr) < s.small || sr < s.small) continue;
    if (best < 0 || sr < best) {
      best = sr;
      best_id = id;
      h.ok = true;
      h.p = o + sr * u;
      h.n = normalized(h.p - c);
      h.mat = static_cast<int>(s.sph[i * SPH_W + 4]);
    }
  }

  if (!h.ok) return false;
  // reflected/transmitted from the unit incoming dir and the geometric
  // (unflipped) normal (:677-699, 773-791)
  double cosi = dot(u, h.n);
  h.refl = u - (2.0 * cosi) * h.n;
  double rho = s.mat[h.mat * MAT_W + 12];
  double modulus = 1.0 - rho * rho * (1.0 - cosi * cosi);
  h.trans = modulus > 0
      ? rho * u - (std::sqrt(modulus) + rho * cosi) * h.n
      : v3(0, 0, 0);
  *out = h;
  *prim_id = best_id;
  return true;
}

// rayTraceRay (:1184-1249)
Vec3 trace_ray(const Scene& s, Vec3 o, Vec3 v, int depth, int exclude) {
  Vec3 color = v3(0, 0, 0);
  Hit h; int pid;
  if (!closest_hit(s, o, v, exclude, &h, &pid)) return color;

  Vec3 u = normalized(v);
  for (int l = 0; l < s.nl; l++) {
    Vec3 lpos = v3(s.light[l * LIGHT_W], s.light[l * LIGHT_W + 1],
                   s.light[l * LIGHT_W + 2]);
    Vec3 lcol = v3(s.light[l * LIGHT_W + 3], s.light[l * LIGHT_W + 4],
                   s.light[l * LIGHT_W + 5]);
    Vec3 sv = lpos - h.p;
    Hit occ; int opid;
    bool blocked = closest_hit(s, h.p, sv, pid, &occ, &opid);
    Vec3 ot = blocked ? mat_col(s, occ.mat, 9) : v3(0, 0, 0);
    bool occluder_transparent = ot.x != 0 || ot.y != 0 || ot.z != 0;
    if (!blocked || occluder_transparent) {
      double dist = norm(sv);
      double att = s.atten / (s.atten + dist * dist);
      Vec3 lc = att * lcol;
      Vec3 sh = normalized(sv);
      Vec3 amb = mat_col(s, h.mat, 0), dif = mat_col(s, h.mat, 3),
           spe = mat_col(s, h.mat, 6);
      color = color + hadamard(amb, lc) +
              std::fabs(dot(h.n, sh)) * hadamard(dif, lc) +
              std::fabs(dot(u, h.refl)) * hadamard(spe, lc);
    }
  }

  if (depth > 0) {
    Vec3 T = mat_col(s, h.mat, 9);
    Vec3 opacity = v3(1, 1, 1) - T;
    bool t_nonzero = T.x != 0 || T.y != 0 || T.z != 0;
    if (t_nonzero && norm(T) > s.small) {
      Vec3 ct = trace_ray(s, h.p, h.trans, depth - 1, pid);
      color = color + hadamard(T, ct);
    }
    if (opacity.x != 0 || opacity.y != 0 || opacity.z != 0) {
      Vec3 cr = trace_ray(s, h.p, h.refl, depth - 1, pid);
      color = color + hadamard(opacity, cr);
    }
  }
  return color;
}

}  // namespace

extern "C" {

// rayTraceScreen (:1251-1324): camera basis + per-pixel rays; j=0 is the
// bottom scanline.  out: [height*width*3] doubles.
void oracle_render(const double* sph, int ns, const double* tri, int nt,
                   const double* mat, int nm, const double* light, int nl,
                   const double* grp, int ng, const double* board,
                   const double* camera, int width, int height, int max_depth,
                   double small, double atten, int prune, int exclude_origin,
                   double* out) {
  Scene s;
  s.sph = sph; s.ns = ns; s.tri = tri; s.nt = nt;
  s.mat = mat; s.nm = nm; s.light = light; s.nl = nl;
  s.grp = grp; s.ng = ng;
  s.board_pos = v3(board[0], board[1], board[2]);
  s.board_half = board[3]; s.board_square = board[4];
  s.white_id = static_cast<int>(board[5]);
  s.black_id = static_cast<int>(board[6]);
  s.small = small; s.atten = atten; s.prune = prune != 0;
  (void)exclude_origin;  // exclusion is always on (SEMANTICS.md D1)

  // Triangle ctor precomputation (:406-433)
  s.tn = new double[nt * 3];
  s.tu = new double[nt * 3];
  s.tv = new double[nt * 3];
  s.tdots = new double[nt * 4];
  s.tdeg = new bool[nt];
  for (int i = 0; i < nt; i++) {
    Vec3 v0 = v3(tri[i * TRI_W], tri[i * TRI_W + 1], tri[i * TRI_W + 2]);
    Vec3 v1 = v3(tri[i * TRI_W + 3], tri[i * TRI_W + 4], tri[i * TRI_W + 5]);
    Vec3 v2 = v3(tri[i * TRI_W + 6], tri[i * TRI_W + 7], tri[i * TRI_W + 8]);
    Vec3 u = v1 - v0, v = v2 - v0;
    Vec3 n = cross(u, v);
    double nl2 = norm(n);
    bool deg = nl2 < small;
    n = nl2 > 0 ? (1.0 / nl2) * n : n;
    double uv = dot(u, v), uu = dot(u, u), vv = dot(v, v);
    double den = uv * uv - uu * vv;
    deg = deg || std::fabs(den) < small;
    s.tn[i * 3] = n.x; s.tn[i * 3 + 1] = n.y; s.tn[i * 3 + 2] = n.z;
    s.tu[i * 3] = u.x; s.tu[i * 3 + 1] = u.y; s.tu[i * 3 + 2] = u.z;
    s.tv[i * 3] = v.x; s.tv[i * 3 + 1] = v.y; s.tv[i * 3 + 2] = v.z;
    s.tdots[i * 4] = uv; s.tdots[i * 4 + 1] = uu;
    s.tdots[i * 4 + 2] = vv; s.tdots[i * 4 + 3] = den;
    s.tdeg[i] = deg;
  }

  Vec3 eye = v3(camera[0], camera[1], camera[2]);
  Vec3 look_at = v3(camera[3], camera[4], camera[5]);
  Vec3 up = v3(camera[6], camera[7], camera[8]);
  double bx = camera[9], by = camera[10], scale = camera[11];

  Vec3 look = look_at - eye;
  Vec3 right = normalized(cross(look, up));
  Vec3 up2 = normalized(cross(right, look));
  Vec3 base = look_at + bx * right + by * up2;

  for (int j = 0; j < height; j++) {
    for (int i = 0; i < width; i++) {
      Vec3 pt = base + (i * scale) * right + (j * scale) * up2;
      Vec3 c = trace_ray(s, eye, pt - eye, max_depth, -1);
      double* px = out + (static_cast<int64_t>(j) * width + i) * 3;
      px[0] = c.x; px[1] = c.y; px[2] = c.z;
    }
  }

  delete[] s.tn; delete[] s.tu; delete[] s.tv;
  delete[] s.tdots; delete[] s.tdeg;
}

}  // extern "C"
