// Host-side signed-distance baking for mesh obstacles.
//
// Role: the scene-compile data path. The reference queries mesh distance at
// runtime on the GPU through a Warp BVH (`curobo/_src/geom/data/data_mesh.py:600`,
// `wp.mesh_query_point` over a SAH-built `wp.Mesh`). The TPU design instead
// bakes every mesh into a dense ESDF voxel grid once, at compile_scene time,
// and samples it with trilinear gathers on device — so the closest-point
// query moves from a device kernel to THIS host library. A brute-force
// numpy implementation is O(points x triangles) and takes minutes for
// real meshes; this file provides the native equivalent of the reference's
// BVH path: a median-split AABB tree with branch-and-bound closest-triangle
// queries and parity ray casting for the sign, OpenMP-parallel over query
// points.
//
// Exposed as a tiny C ABI (build: see curobo_tpu/native/build.py) and
// loaded via ctypes — no pybind dependency.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

inline Vec3 operator-(const Vec3 &a, const Vec3 &b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
inline Vec3 operator+(const Vec3 &a, const Vec3 &b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
inline Vec3 operator*(double s, const Vec3 &a) { return {s * a.x, s * a.y, s * a.z}; }
inline double dot(const Vec3 &a, const Vec3 &b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
inline Vec3 cross(const Vec3 &a, const Vec3 &b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double norm2(const Vec3 &a) { return dot(a, a); }

// Closest point on triangle (Ericson, Real-Time Collision Detection 5.1.5).
inline double point_tri_dist2(const Vec3 &p, const Vec3 &a, const Vec3 &b,
                              const Vec3 &c) {
  Vec3 ab = b - a, ac = c - a, ap = p - a;
  double d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0.0 && d2 <= 0.0) return norm2(p - a);
  Vec3 bp = p - b;
  double d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0.0 && d4 <= d3) return norm2(p - b);
  double vc = d1 * d4 - d3 * d2;
  if (vc <= 0.0 && d1 >= 0.0 && d3 <= 0.0) {
    double v = d1 / (d1 - d3);
    return norm2(p - (a + v * ab));
  }
  Vec3 cp = p - c;
  double d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0.0 && d5 <= d6) return norm2(p - c);
  double vb = d5 * d2 - d1 * d6;
  if (vb <= 0.0 && d2 >= 0.0 && d6 <= 0.0) {
    double w = d2 / (d2 - d6);
    return norm2(p - (a + w * ac));
  }
  double va = d3 * d6 - d5 * d4;
  if (va <= 0.0 && (d4 - d3) >= 0.0 && (d5 - d6) >= 0.0) {
    double w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    return norm2(p - (b + w * (c - b)));
  }
  double denom = 1.0 / (va + vb + vc);
  double v = vb * denom, w = vc * denom;
  return norm2(p - (a + v * ab + w * ac));
}

struct AABB {
  Vec3 lo{1e300, 1e300, 1e300}, hi{-1e300, -1e300, -1e300};
  void grow(const Vec3 &p) {
    lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y); lo.z = std::min(lo.z, p.z);
    hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y); hi.z = std::max(hi.z, p.z);
  }
  void grow(const AABB &o) { grow(o.lo); grow(o.hi); }
  double dist2(const Vec3 &p) const {
    double dx = std::max({lo.x - p.x, 0.0, p.x - hi.x});
    double dy = std::max({lo.y - p.y, 0.0, p.y - hi.y});
    double dz = std::max({lo.z - p.z, 0.0, p.z - hi.z});
    return dx * dx + dy * dy + dz * dz;
  }
};

struct Node {
  AABB box;
  int32_t left = -1;   // internal: child index; leaf: first tri index
  int32_t count = 0;   // leaf: number of tris (0 for internal)
  int32_t right = -1;
};

struct BVH {
  std::vector<Node> nodes;
  std::vector<int32_t> tri_order;
  std::vector<Vec3> va, vb, vc;  // triangle vertices in tri_order
  std::vector<Vec3> centroid;

  int32_t build(int32_t begin, int32_t end, std::vector<int32_t> &idx,
                const std::vector<AABB> &tb, const std::vector<Vec3> &cent) {
    Node n;
    for (int32_t i = begin; i < end; ++i) n.box.grow(tb[idx[i]]);
    int32_t me = (int32_t)nodes.size();
    nodes.push_back(n);
    if (end - begin <= 4) {
      nodes[me].left = begin;
      nodes[me].count = end - begin;
      return me;
    }
    Vec3 ext = n.box.hi - n.box.lo;
    int axis = (ext.x > ext.y && ext.x > ext.z) ? 0 : (ext.y > ext.z ? 1 : 2);
    int32_t mid = (begin + end) / 2;
    std::nth_element(idx.begin() + begin, idx.begin() + mid, idx.begin() + end,
                     [&](int32_t a, int32_t b) {
                       const Vec3 &ca = cent[a], &cb = cent[b];
                       return axis == 0 ? ca.x < cb.x : (axis == 1 ? ca.y < cb.y : ca.z < cb.z);
                     });
    int32_t l = build(begin, mid, idx, tb, cent);
    int32_t r = build(mid, end, idx, tb, cent);
    nodes[me].left = l;
    nodes[me].right = r;
    nodes[me].count = 0;
    return me;
  }

  void init(const double *verts, const int64_t *faces, int64_t n_tri) {
    std::vector<AABB> tb(n_tri);
    std::vector<Vec3> cent(n_tri);
    std::vector<Vec3> A(n_tri), B(n_tri), C(n_tri);
    for (int64_t t = 0; t < n_tri; ++t) {
      auto v = [&](int64_t vi) {
        return Vec3{verts[3 * vi], verts[3 * vi + 1], verts[3 * vi + 2]};
      };
      A[t] = v(faces[3 * t]); B[t] = v(faces[3 * t + 1]); C[t] = v(faces[3 * t + 2]);
      tb[t].grow(A[t]); tb[t].grow(B[t]); tb[t].grow(C[t]);
      cent[t] = (1.0 / 3.0) * (A[t] + B[t] + C[t]);
    }
    std::vector<int32_t> idx(n_tri);
    for (int64_t i = 0; i < n_tri; ++i) idx[i] = (int32_t)i;
    nodes.reserve(2 * n_tri);
    build(0, (int32_t)n_tri, idx, tb, cent);
    tri_order = idx;
    va.resize(n_tri); vb.resize(n_tri); vc.resize(n_tri);
    for (int64_t i = 0; i < n_tri; ++i) {
      va[i] = A[idx[i]]; vb[i] = B[idx[i]]; vc[i] = C[idx[i]];
    }
  }

  // Branch-and-bound closest-triangle distance^2.
  double closest2(const Vec3 &p) const {
    double best = std::numeric_limits<double>::max();
    int32_t stack[128];
    int sp = 0;
    stack[sp++] = 0;
    while (sp) {
      int32_t ni = stack[--sp];
      const Node &n = nodes[ni];
      if (n.box.dist2(p) >= best) continue;
      if (n.count > 0) {
        for (int32_t i = n.left; i < n.left + n.count; ++i)
          best = std::min(best, point_tri_dist2(p, va[i], vb[i], vc[i]));
      } else {
        // visit nearer child first for tighter pruning
        double dl = nodes[n.left].box.dist2(p);
        double dr = nodes[n.right].box.dist2(p);
        if (dl < dr) {
          if (dr < best) stack[sp++] = n.right;
          if (dl < best) stack[sp++] = n.left;
        } else {
          if (dl < best) stack[sp++] = n.left;
          if (dr < best) stack[sp++] = n.right;
        }
      }
    }
    return best;
  }

  // Count ray-triangle hits along +x (Moller-Trumbore); even-odd parity sign.
  int ray_px_hits(const Vec3 &p) const {
    int hits = 0;
    int32_t stack[128];
    int sp = 0;
    stack[sp++] = 0;
    while (sp) {
      int32_t ni = stack[--sp];
      const Node &n = nodes[ni];
      // ray +x from p intersects box iff box not behind and y/z inside
      if (n.box.hi.x < p.x || p.y < n.box.lo.y || p.y > n.box.hi.y ||
          p.z < n.box.lo.z || p.z > n.box.hi.z)
        continue;
      if (n.count > 0) {
        for (int32_t i = n.left; i < n.left + n.count; ++i) {
          Vec3 e1 = vb[i] - va[i], e2 = vc[i] - va[i];
          // h = cross(d, e2) with d = (1,0,0)
          Vec3 h{0.0, -e2.z, e2.y};
          double det = dot(e1, h);
          if (std::fabs(det) < 1e-12) continue;
          double inv = 1.0 / det;
          Vec3 s = p - va[i];
          double u = dot(s, h) * inv;
          if (u < 0.0 || u > 1.0) continue;
          Vec3 q = cross(s, e1);
          double v = q.x * inv;  // dot(d, q)
          if (v < 0.0 || u + v > 1.0) continue;
          double t = dot(q, e2) * inv;
          if (t > 1e-9) ++hits;
        }
      } else {
        stack[sp++] = n.left;
        stack[sp++] = n.right;
      }
    }
    return hits;
  }
};

}  // namespace

extern "C" {

// Signed distance from each query point to the mesh surface.
//   verts:  (n_verts, 3) float64
//   faces:  (n_tris, 3) int64
//   points: (n_points, 3) float64
//   out:    (n_points,) float32   negative inside (even-odd parity)
// Returns 0 on success.
int curobo_mesh_sdf(const double *verts, int64_t n_verts, const int64_t *faces,
                    int64_t n_tris, const double *points, int64_t n_points,
                    float *out) {
  if (n_verts <= 0 || n_tris <= 0 || n_points < 0) return 1;
  BVH bvh;
  bvh.init(verts, faces, n_tris);
#pragma omp parallel for schedule(dynamic, 256)
  for (int64_t i = 0; i < n_points; ++i) {
    Vec3 p{points[3 * i], points[3 * i + 1], points[3 * i + 2]};
    double d = std::sqrt(bvh.closest2(p));
    if (bvh.ray_px_hits(p) % 2 == 1) d = -d;
    out[i] = (float)d;
  }
  return 0;
}

// Unsigned closest distance only (used by sphere fitting / validation).
int curobo_mesh_udf(const double *verts, int64_t n_verts, const int64_t *faces,
                    int64_t n_tris, const double *points, int64_t n_points,
                    float *out) {
  if (n_verts <= 0 || n_tris <= 0 || n_points < 0) return 1;
  BVH bvh;
  bvh.init(verts, faces, n_tris);
#pragma omp parallel for schedule(dynamic, 256)
  for (int64_t i = 0; i < n_points; ++i) {
    Vec3 p{points[3 * i], points[3 * i + 1], points[3 * i + 2]};
    out[i] = (float)std::sqrt(bvh.closest2(p));
  }
  return 0;
}

}  // extern "C"
