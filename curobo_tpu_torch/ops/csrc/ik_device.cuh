// Device functions shared by the two IK kernels (ik_cost_grad, ik_solve).
//
// Replaces the body of the Pallas IK kernels, `PallasIKCost._cost_fns` and the
// in-kernel optimizer loops `_lbfgs_loop` / `_mppi_loop`
// (curobo_tpu/ops/pallas_ik.py). One thread owns one configuration. Robot and
// world are runtime tables in global memory (every thread of a warp reads the
// same address, so the loads are broadcasts served by L1); per-thread state
// (link frames, sphere centres, reverse-pass accumulators, L-BFGS history)
// lives in a scratch buffer allocated by the caller and laid out
// [block][slot][lane], so that a warp's accesses to one slot are contiguous.
//
// The FK reverse pass is written by hand: cotangents on sphere centres and on
// the tool pose become a force and a torque (about the world origin) on their
// link, one sweep from the leaves to the root adds them into the parents, and
// d/dq of a revolute joint is mult * axis_world . (torque about the joint
// origin), of a prismatic joint mult * axis_world . force.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define IK_MAXD 16  // most degrees of freedom one thread keeps in registers

// ---- tables (mirrored by ctypes structures in ops/ik_kernels.py) ----------
struct IKRobot {
  const int* link_i;    // (L, 3)  kind (0 const, 1 revolute, 2 prismatic), parent, dof
  const float* link_f;  // (L, 17) mult, off, R[9] row-major, p[3], axis[3]
  const float* sph_f;   // (S, 4)  centre in link frame, radius (< 0 = disabled)
  const int* sph_link;  // (S,)
  const int* pair_i;    // (P, 2)  live self-collision pairs
  const float* pair_m;  // (P,)    margin
  const float* dof_f;   // (D, 6)  lim_lo, lim_hi, clip_lo, clip_hi, retract, null_w
  const float* cfg_f;   // (8,)    pos_w, rot_w, bound_w, null_space_w, sc_w, sc_act, coll_w, coll_act
  int L, S, P, D, tool;
};

struct IKWorld {
  const float* cub;  // (Kc, 16) rot row-major 9 | pos 3 | half 3 | enabled
  const float* sph;  // (Ks, 5)  centre 3 | radius | enabled
  const float* cap;  // (Kp, 8)  endpoint a 3 | ba 3 | radius | enabled
  const float* cyl;  // (Ky, 15) rot row-major 9 | pos 3 | radius | half_height | enabled
  int Kc, Ks, Kp, Ky;
};

struct IKSolveCfg {
  int warmup_iters, warmup_history;
  int mppi_iters, n_particles;
  float init_std, std_decay, min_std, temperature, step_size;
  int lbfgs_iters, history;
  float max_step;
  int n_linesearch;
  float ls_base, ls_ratio;
  unsigned int seed_lo, seed_hi;
};

struct IKMetrics {
  float pe2, re2, self_viol, min_clear;
};

#define IK_BLOCK 32  // threads per block: one warp

// Per-thread scratch. A block's slots are contiguous, [block][slot][lane], so
// that a warp's access to one slot is one 128-byte line and a block's working
// set is one dense range of the address space (measured on an H100: about 10 %
// faster than interleaving all threads of the grid per slot, where slots lie
// 100 lines apart). `base` points at this thread's lane of its block's slot 0.
struct IKScratch {
  float* base;
  int n;  // configuration index
  __device__ __forceinline__ float& at(int slot) const { return base[slot * IK_BLOCK]; }
};

__device__ __forceinline__ IKScratch ik_scratch(float* scratch, int slots, int n) {
  return IKScratch{scratch + ((size_t)blockIdx.x * slots) * IK_BLOCK + threadIdx.x, n};
}

#define IK_WANT_GRAD 1
#define IK_POSE_ONLY 2
#define IK_METRICS 4

__host__ __device__ inline int ik_eval_slots(int L, int S) { return 18 * L + 6 * S; }
__host__ __device__ inline int ik_hist_slots(int H, int D) { return 2 * H * D + 3 * H; }

// sign with sign(0) = 0 (copysignf would give +-1 at 0)
__device__ __forceinline__ float ik_sign(float v) {
  return (v > 0.0f) ? 1.0f : ((v < 0.0f) ? -1.0f : 0.0f);
}

// ---------------------------------------------------------------------------
// Min signed distance of one point over the four obstacle tables, first strict
// minimum in table order (cuboid, sphere, capsule, cylinder); disabled rows
// count as 1e6. With want_grad the analytic gradient of the argmin obstacle.
// ---------------------------------------------------------------------------
__device__ __noinline__ float ik_scene_msdf(const IKWorld& w, float x, float y, float z,
                                            bool want_grad, float* g) {
  const float big = 1.0e6f;
  float md = big;
  g[0] = g[1] = g[2] = 0.0f;
  for (int k = 0; k < w.Kc; ++k) {
    const float* r = w.cub + 16 * k;
    if (!(r[15] > 0.5f)) continue;
    float ux = x - r[9], uy = y - r[10], uz = z - r[11];
    float lx = r[0] * ux + r[3] * uy + r[6] * uz;
    float ly = r[1] * ux + r[4] * uy + r[7] * uz;
    float lz = r[2] * ux + r[5] * uy + r[8] * uz;
    float qx = fabsf(lx) - r[12], qy = fabsf(ly) - r[13], qz = fabsf(lz) - r[14];
    float mqx = fmaxf(qx, 0.0f), mqy = fmaxf(qy, 0.0f), mqz = fmaxf(qz, 0.0f);
    float o = sqrtf(mqx * mqx + mqy * mqy + mqz * mqz + 1e-12f);
    float inside_max = fmaxf(qx, fmaxf(qy, qz));
    float d = o + fminf(inside_max, 0.0f);
    if (d < md) {
      md = d;
      if (want_grad) {
        float sx = ik_sign(lx), sy = ik_sign(ly), sz = ik_sign(lz);
        float glx, gly, glz;
        if (inside_max > 0.0f) {
          glx = sx * mqx / o; gly = sy * mqy / o; glz = sz * mqz / o;
        } else {
          bool ax = (qx >= qy) && (qx >= qz);
          bool ay = (!ax) && (qy >= qz);
          bool az = !(ax || ay);
          glx = ax ? sx : 0.0f; gly = ay ? sy : 0.0f; glz = az ? sz : 0.0f;
        }
        g[0] = r[0] * glx + r[1] * gly + r[2] * glz;
        g[1] = r[3] * glx + r[4] * gly + r[5] * glz;
        g[2] = r[6] * glx + r[7] * gly + r[8] * glz;
      }
    }
  }
  for (int k = 0; k < w.Ks; ++k) {
    const float* r = w.sph + 5 * k;
    if (!(r[4] > 0.5f)) continue;
    float ux = x - r[0], uy = y - r[1], uz = z - r[2];
    float n = sqrtf(ux * ux + uy * uy + uz * uz + 1e-12f);
    float d = n - r[3];
    if (d < md) {
      md = d;
      if (want_grad) { g[0] = ux / n; g[1] = uy / n; g[2] = uz / n; }
    }
  }
  for (int k = 0; k < w.Kp; ++k) {
    const float* r = w.cap + 8 * k;
    if (!(r[7] > 0.5f)) continue;
    float denom = fmaxf(r[3] * r[3] + r[4] * r[4] + r[5] * r[5], 1e-12f);
    float px = x - r[0], py = y - r[1], pz = z - r[2];
    float h = fminf(fmaxf((px * r[3] + py * r[4] + pz * r[5]) / denom, 0.0f), 1.0f);
    float ux = px - r[3] * h, uy = py - r[4] * h, uz = pz - r[5] * h;
    float n = sqrtf(ux * ux + uy * uy + uz * uz + 1e-12f);
    float d = n - r[6];
    if (d < md) {
      md = d;
      if (want_grad) { g[0] = ux / n; g[1] = uy / n; g[2] = uz / n; }
    }
  }
  for (int k = 0; k < w.Ky; ++k) {
    const float* r = w.cyl + 15 * k;
    if (!(r[14] > 0.5f)) continue;
    float ux = x - r[9], uy = y - r[10], uz = z - r[11];
    float lx = r[0] * ux + r[3] * uy + r[6] * uz;
    float ly = r[1] * ux + r[4] * uy + r[7] * uz;
    float lz = r[2] * ux + r[5] * uy + r[8] * uz;
    float rad = sqrtf(lx * lx + ly * ly + 1e-12f);
    float dr = rad - r[12];
    float dz = fabsf(lz) - r[13];
    float mdr = fmaxf(dr, 0.0f), mdz = fmaxf(dz, 0.0f);
    float o = sqrtf(mdr * mdr + mdz * mdz + 1e-12f);
    float inside_max = fmaxf(dr, dz);
    float d = o + fminf(inside_max, 0.0f);
    if (d < md) {
      md = d;
      if (want_grad) {
        float rx = lx / rad, ry = ly / rad, sz = ik_sign(lz);
        float glx, gly, glz;
        if (inside_max > 0.0f) {
          glx = mdr * rx / o; gly = mdr * ry / o; glz = mdz * sz / o;
        } else {
          bool radial = dr >= dz;
          glx = radial ? rx : 0.0f; gly = radial ? ry : 0.0f; glz = radial ? 0.0f : sz;
        }
        g[0] = r[0] * glx + r[1] * gly + r[2] * glz;
        g[1] = r[3] * glx + r[4] * gly + r[5] * glz;
        g[2] = r[6] * glx + r[7] * gly + r[8] * glz;
      }
    }
  }
  return md;
}

// ---------------------------------------------------------------------------
// Pieces of one evaluation shared by the IK and the trajectory kernels. `SC` is
// a scratch accessor with `float& at(int slot)` (IKScratch here, TrajScratch in
// traj_kernels.cu); link frames sit at slots oR (9 L) and oP (3 L), the
// reverse-pass force and torque accumulators at oF and oT (3 L each), sphere
// centres at oC and their cotangents at oG (3 S each).
// ---------------------------------------------------------------------------
template <class SC>
__device__ __forceinline__ void ik_fk_forward(const IKRobot& rb, const SC& sc, const float* q,
                                              int oR, int oP) {
  for (int i = 0; i < rb.L; ++i) {
    const int kind = rb.link_i[3 * i], par = rb.link_i[3 * i + 1], dof = rb.link_i[3 * i + 2];
    const float* lf = rb.link_f + 17 * i;
    float Rl[9], pl[3];
    if (kind == 1) {
      float val = lf[0] * q[dof] + lf[1];
      float s, c;
      sincosf(val, &s, &c);
      float ax = lf[14], ay = lf[15], az = lf[16], omc = 1.0f - c;
      float r[9] = {c + omc * ax * ax,      omc * ax * ay - s * az, omc * ax * az + s * ay,
                    omc * ax * ay + s * az, c + omc * ay * ay,      omc * ay * az - s * ax,
                    omc * ax * az - s * ay, omc * ay * az + s * ax, c + omc * az * az};
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b)
          Rl[3 * a + b] = lf[2 + 3 * a] * r[b] + lf[2 + 3 * a + 1] * r[3 + b] + lf[2 + 3 * a + 2] * r[6 + b];
      pl[0] = lf[11]; pl[1] = lf[12]; pl[2] = lf[13];
    } else {
      for (int a = 0; a < 9; ++a) Rl[a] = lf[2 + a];
      pl[0] = lf[11]; pl[1] = lf[12]; pl[2] = lf[13];
      if (kind == 2) {
        float val = lf[0] * q[dof] + lf[1];
        float ax = lf[14] * val, ay = lf[15] * val, az = lf[16] * val;
        for (int a = 0; a < 3; ++a)
          pl[a] += lf[2 + 3 * a] * ax + lf[2 + 3 * a + 1] * ay + lf[2 + 3 * a + 2] * az;
      }
    }
    if (par < 0) {
      for (int a = 0; a < 9; ++a) sc.at(oR + 9 * i + a) = Rl[a];
      for (int a = 0; a < 3; ++a) sc.at(oP + 3 * i + a) = pl[a];
    } else {
      float Rp[9];
      for (int a = 0; a < 9; ++a) Rp[a] = sc.at(oR + 9 * par + a);
      for (int a = 0; a < 3; ++a) {
        for (int b = 0; b < 3; ++b)
          sc.at(oR + 9 * i + 3 * a + b) =
              Rp[3 * a] * Rl[b] + Rp[3 * a + 1] * Rl[3 + b] + Rp[3 * a + 2] * Rl[6 + b];
        sc.at(oP + 3 * i + a) = sc.at(oP + 3 * par + a) + Rp[3 * a] * pl[0] +
                                Rp[3 * a + 1] * pl[1] + Rp[3 * a + 2] * pl[2];
      }
    }
  }
}

// Position and rotation error of the tool frame (rotation Rt, origin tp)
// against a goal (x, y, z, qw, qx, qy, qz); the rotation error is the rotation
// vector of conj(goal) * tool, e = (rx, ry, rz) * scale.
struct IKPoseErr {
  float dx, dy, dz, pe2, rx, ry, rz, scale, re2;
};

__device__ __forceinline__ IKPoseErr ik_pose_error(const float* goal, const float* Rt,
                                                   const float* tp) {
  IKPoseErr e;
  e.dx = goal[0] - tp[0]; e.dy = goal[1] - tp[1]; e.dz = goal[2] - tp[2];
  e.pe2 = e.dx * e.dx + e.dy * e.dy + e.dz * e.dz;

  // rotation matrix -> unit quaternion (w >= 0), dominant component first
  float tq[4];
  {
    float m00 = Rt[0], m01 = Rt[1], m02 = Rt[2], m10 = Rt[3], m11 = Rt[4], m12 = Rt[5];
    float m20 = Rt[6], m21 = Rt[7], m22 = Rt[8];
    float qw2 = fmaxf(1.0f + m00 + m11 + m22, 0.0f);
    float qx2 = fmaxf(1.0f + m00 - m11 - m22, 0.0f);
    float qy2 = fmaxf(1.0f - m00 + m11 - m22, 0.0f);
    float qz2 = fmaxf(1.0f - m00 - m11 + m22, 0.0f);
    float cw, cx, cy, cz;
    if (qw2 >= qx2 && qw2 >= qy2 && qw2 >= qz2) {
      cw = qw2; cx = m21 - m12; cy = m02 - m20; cz = m10 - m01;
    } else if (qx2 >= qy2 && qx2 >= qz2) {
      cw = m21 - m12; cx = qx2; cy = m01 + m10; cz = m02 + m20;
    } else if (qy2 >= qz2) {
      cw = m02 - m20; cx = m01 + m10; cy = qy2; cz = m12 + m21;
    } else {
      cw = m10 - m01; cx = m02 + m20; cy = m12 + m21; cz = qz2;
    }
    float norm = sqrtf(fmaxf(cw * cw + cx * cx + cy * cy + cz * cz, 1e-12f));
    float inv = ((cw < 0.0f) ? -1.0f : 1.0f) / norm;
    tq[0] = cw * inv; tq[1] = cx * inv; tq[2] = cy * inv; tq[3] = cz * inv;
  }
  // dq = conj(goal) * tool, canonical sign, rotation vector e = axis * angle
  float gw = goal[3], gx = goal[4], gy = goal[5], gz = goal[6];
  float rw = gw * tq[0] + gx * tq[1] + gy * tq[2] + gz * tq[3];
  float rx = gw * tq[1] - gx * tq[0] - gy * tq[3] + gz * tq[2];
  float ry = gw * tq[2] + gx * tq[3] - gy * tq[0] - gz * tq[1];
  float rz = gw * tq[3] - gx * tq[2] + gy * tq[1] - gz * tq[0];
  if (rw < 0.0f) { rw = -rw; rx = -rx; ry = -ry; rz = -rz; }
  float s2 = rx * rx + ry * ry + rz * rz;
  bool small = s2 < 1e-12f;
  float s = sqrtf(small ? 1.0f : s2);
  float angle = 2.0f * atan2f(s, rw);
  e.scale = small ? 2.0f : angle / s;
  e.rx = rx; e.ry = ry; e.rz = rz;
  e.re2 = s2 * e.scale * e.scale;
  return e;
}

// Cotangent of pos_w * pe2 + rot_w * re2 as a force on the tool origin and a
// torque (about the world origin) on the tool link. Overwrites the tool's
// accumulators, which the caller has zeroed.
template <class SC>
__device__ __forceinline__ void ik_tool_wrench(const SC& sc, int ti, int oF, int oT, float pos_w,
                                               float rot_w, const IKPoseErr& e, const float* Rt,
                                               const float* tp) {
  // position term: force on the tool origin; rotation term: pure torque
  float fx = -2.0f * pos_w * e.dx, fy = -2.0f * pos_w * e.dy, fz = -2.0f * pos_w * e.dz;
  float ex = e.rx * e.scale, ey = e.ry * e.scale, ez = e.rz * e.scale;
  float k = 2.0f * rot_w;
  float tx = k * (Rt[0] * ex + Rt[1] * ey + Rt[2] * ez);
  float ty = k * (Rt[3] * ex + Rt[4] * ey + Rt[5] * ez);
  float tz = k * (Rt[6] * ex + Rt[7] * ey + Rt[8] * ez);
  sc.at(oF + 3 * ti) = fx; sc.at(oF + 3 * ti + 1) = fy; sc.at(oF + 3 * ti + 2) = fz;
  sc.at(oT + 3 * ti) = tx + tp[1] * fz - tp[2] * fy;
  sc.at(oT + 3 * ti + 1) = ty + tp[2] * fx - tp[0] * fz;
  sc.at(oT + 3 * ti + 2) = tz + tp[0] * fy - tp[1] * fx;
}

// Sphere-centre cotangents (slot oG) -> force and torque on their links.
template <class SC>
__device__ __forceinline__ void ik_sphere_wrench(const IKRobot& rb, const SC& sc, int oC, int oG,
                                                 int oF, int oT) {
  for (int si = 0; si < rb.S; ++si) {
    const int li = rb.sph_link[si];
    float fx = sc.at(oG + 3 * si), fy = sc.at(oG + 3 * si + 1), fz = sc.at(oG + 3 * si + 2);
    if (fx == 0.0f && fy == 0.0f && fz == 0.0f) continue;
    float cx = sc.at(oC + 3 * si), cy = sc.at(oC + 3 * si + 1), cz = sc.at(oC + 3 * si + 2);
    sc.at(oF + 3 * li) += fx; sc.at(oF + 3 * li + 1) += fy; sc.at(oF + 3 * li + 2) += fz;
    sc.at(oT + 3 * li) += cy * fz - cz * fy;
    sc.at(oT + 3 * li + 1) += cz * fx - cx * fz;
    sc.at(oT + 3 * li + 2) += cx * fy - cy * fx;
  }
}

// Reverse sweep, leaves to root: the accumulated wrenches become d/dq, added
// into grad (which holds the direct terms already).
template <class SC>
__device__ __forceinline__ void ik_fk_reverse(const IKRobot& rb, const SC& sc, float* grad, int oR,
                                              int oP, int oF, int oT) {
  for (int i = rb.L - 1; i >= 0; --i) {
    const int kind = rb.link_i[3 * i], par = rb.link_i[3 * i + 1], dof = rb.link_i[3 * i + 2];
    float F[3], T[3];
    for (int a = 0; a < 3; ++a) { F[a] = sc.at(oF + 3 * i + a); T[a] = sc.at(oT + 3 * i + a); }
    if (kind != 0) {
      const float* lf = rb.link_f + 17 * i;
      float aw[3];
      for (int a = 0; a < 3; ++a)
        aw[a] = sc.at(oR + 9 * i + 3 * a) * lf[14] + sc.at(oR + 9 * i + 3 * a + 1) * lf[15] +
                sc.at(oR + 9 * i + 3 * a + 2) * lf[16];
      float g;
      if (kind == 1) {
        float px = sc.at(oP + 3 * i), py = sc.at(oP + 3 * i + 1), pz = sc.at(oP + 3 * i + 2);
        float qx = T[0] - (py * F[2] - pz * F[1]);
        float qy = T[1] - (pz * F[0] - px * F[2]);
        float qz = T[2] - (px * F[1] - py * F[0]);
        g = aw[0] * qx + aw[1] * qy + aw[2] * qz;
      } else {
        g = aw[0] * F[0] + aw[1] * F[1] + aw[2] * F[2];
      }
      grad[dof] += lf[0] * g;
    }
    if (par >= 0)
      for (int a = 0; a < 3; ++a) { sc.at(oF + 3 * par + a) += F[a]; sc.at(oT + 3 * par + a) += T[a]; }
  }
}

// ---------------------------------------------------------------------------
// The IK objective of one configuration: FK, pose error, joint-limit and
// null-space penalties, self-collision hinge, scene penalty; with IK_WANT_GRAD
// its gradient by the hand-written reverse pass; with IK_METRICS the raw
// quantities of the feasibility test. Scratch slots [0, 18 L + 6 S).
// ---------------------------------------------------------------------------
__device__ __noinline__ float ik_eval(const IKRobot& rb, const IKWorld& w, const IKScratch& sc,
                                      const float* goal, const float* q, float* grad,
                                      int flags, IKMetrics* met) {
  const bool want_grad = (flags & IK_WANT_GRAD) != 0;
  const bool pose_only = (flags & IK_POSE_ONLY) != 0;
  const bool metrics = (flags & IK_METRICS) != 0;
  const int L = rb.L, S = rb.S, D = rb.D;
  const int oR = 0, oP = 9 * L, oF = 12 * L, oT = 15 * L, oC = 18 * L, oG = 18 * L + 3 * S;
  const float pos_w = rb.cfg_f[0], rot_w = rb.cfg_f[1], bound_w = rb.cfg_f[2];
  const float null_w = rb.cfg_f[3], sc_w = rb.cfg_f[4], sc_act = rb.cfg_f[5];
  const float coll_w = rb.cfg_f[6], coll_act = rb.cfg_f[7];

  // ---- forward kinematics ---------------------------------------------------
  ik_fk_forward(rb, sc, q, oR, oP);

  // ---- pose error of the tool frame -------------------------------------------
  const int ti = rb.tool;
  float Rt[9], tp[3];
  for (int a = 0; a < 9; ++a) Rt[a] = sc.at(oR + 9 * ti + a);
  for (int a = 0; a < 3; ++a) tp[a] = sc.at(oP + 3 * ti + a);
  const IKPoseErr pe = ik_pose_error(goal, Rt, tp);
  const float pe2 = pe.pe2, re2 = pe.re2;
  float cost = pos_w * pe2 + rot_w * re2;

  // ---- joint limits + null space -------------------------------------------------
  for (int d = 0; d < D; ++d) {
    const float* df = rb.dof_f + 6 * d;
    float lo_v = fmaxf(df[0] - q[d], 0.0f), hi_v = fmaxf(q[d] - df[1], 0.0f);
    float viol = lo_v + hi_v;
    cost += bound_w * viol * viol;
    float gd = 0.0f;
    if (want_grad)
      gd = 2.0f * bound_w * viol * ((hi_v > 0.0f ? 1.0f : 0.0f) - (lo_v > 0.0f ? 1.0f : 0.0f));
    if (null_w > 0.0f) {
      float dn = (q[d] - df[4]) * df[5];
      cost += null_w * dn * dn;
      if (want_grad) gd += 2.0f * null_w * dn * df[5];
    }
    if (want_grad) grad[d] = gd;
  }

  if (want_grad) {
    for (int a = 0; a < 3 * L; ++a) { sc.at(oF + a) = 0.0f; sc.at(oT + a) = 0.0f; }
    ik_tool_wrench(sc, ti, oF, oT, pos_w, rot_w, pe, Rt, tp);
  }

  float self_viol = -1.0e6f, min_clear = 1.0e6f;
  if (!pose_only) {
    // ---- sphere centres ------------------------------------------------------------
    for (int si = 0; si < S; ++si) {
      const float* sf = rb.sph_f + 4 * si;
      const int li = rb.sph_link[si];
      for (int a = 0; a < 3; ++a) {
        sc.at(oC + 3 * si + a) = sc.at(oR + 9 * li + 3 * a) * sf[0] +
                                 sc.at(oR + 9 * li + 3 * a + 1) * sf[1] +
                                 sc.at(oR + 9 * li + 3 * a + 2) * sf[2] + sc.at(oP + 3 * li + a);
        if (want_grad) sc.at(oG + 3 * si + a) = 0.0f;
      }
    }
    // ---- self collision: hinge over live pairs ------------------------------------------
    float sc_sum = 0.0f;
    for (int k = 0; k < rb.P; ++k) {
      const int a = rb.pair_i[2 * k], b = rb.pair_i[2 * k + 1];
      const float m = rb.pair_m[k];
      float ddx = sc.at(oC + 3 * a) - sc.at(oC + 3 * b);
      float ddy = sc.at(oC + 3 * a + 1) - sc.at(oC + 3 * b + 1);
      float ddz = sc.at(oC + 3 * a + 2) - sc.at(oC + 3 * b + 2);
      float dist = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz + 1e-12f);
      float h = m + sc_act - dist;
      if (h > 0.0f) {
        sc_sum += h;
        if (want_grad) {
          float cf = -sc_w / dist;
          sc.at(oG + 3 * a) += cf * ddx; sc.at(oG + 3 * a + 1) += cf * ddy; sc.at(oG + 3 * a + 2) += cf * ddz;
          sc.at(oG + 3 * b) -= cf * ddx; sc.at(oG + 3 * b + 1) -= cf * ddy; sc.at(oG + 3 * b + 2) -= cf * ddz;
        }
      }
      if (metrics) self_viol = fmaxf(self_viol, m - dist);
    }
    cost += sc_w * sc_sum;
    // ---- scene: penalty on the min signed distance of every live sphere --------------
    float pen = 0.0f;
    for (int si = 0; si < S; ++si) {
      const float rad = rb.sph_f[4 * si + 3];
      if (rad < 0.0f) continue;
      float g3[3];
      float msdf = ik_scene_msdf(w, sc.at(oC + 3 * si), sc.at(oC + 3 * si + 1),
                                 sc.at(oC + 3 * si + 2), want_grad, g3);
      float viol = coll_act + rad - msdf;
      if (viol > 0.0f) {
        pen += viol;
        if (want_grad)
          for (int a = 0; a < 3; ++a) sc.at(oG + 3 * si + a) -= coll_w * g3[a];
      }
      if (metrics) min_clear = fminf(min_clear, msdf - rad);
    }
    cost += coll_w * pen;
    // ---- sphere cotangents -> force and torque on their links ----------------------------
    if (want_grad) ik_sphere_wrench(rb, sc, oC, oG, oF, oT);
  }

  // ---- reverse sweep, leaves to root ------------------------------------------------
  if (want_grad) ik_fk_reverse(rb, sc, grad, oR, oP, oF, oT);

  if (metrics) {
    met->pe2 = pe2; met->re2 = re2; met->self_viol = self_viol; met->min_clear = min_clear;
  }
  return cost;
}

__device__ __forceinline__ void ik_clip(const IKRobot& rb, float* x) {
  for (int d = 0; d < rb.D; ++d)
    x[d] = fminf(fmaxf(x[d], rb.dof_f[6 * d + 2]), rb.dof_f[6 * d + 3]);
}

__device__ __forceinline__ float ik_dot(const float* a, const float* b, int D) {
  float s = 0.0f;
  for (int d = 0; d < D; ++d) s += a[d] * b[d];
  return s;
}

// ---------------------------------------------------------------------------
// L-BFGS with two-loop recursion over a ring of `m` history slots (logical slot
// m-1 is the newest) and a best-of-n backtracking line search. `mode` is 0 for
// the full objective or IK_POSE_ONLY for the warm-up stage. x is replaced by
// the best iterate after a gradient evaluation. History scratch starts at slot
// `oH`: S (m D), Y (m D), rho (m), valid (m), alpha (m).
// ---------------------------------------------------------------------------
__device__ __noinline__ float ik_lbfgs(const IKRobot& rb, const IKWorld& w, const IKScratch& sc,
                                       int oH, const float* goal, float* x, int mode, int n_iters,
                                       int m, float max_step, int n_ls, float ls_base,
                                       float ls_log_ratio) {
  const int D = rb.D;
  const int oS = oH, oY = oH + m * D, oRho = oH + 2 * m * D, oV = oRho + m, oA = oV + m;
  float g[IK_MAXD], dvec[IK_MAXD], xn[IK_MAXD], gn[IK_MAXD], bx[IK_MAXD], r[IK_MAXD];
  ik_clip(rb, x);
  float c = ik_eval(rb, w, sc, goal, x, g, mode | IK_WANT_GRAD, nullptr);
  for (int i = 0; i < m; ++i) sc.at(oV + i) = 0.0f;
  int head = 0;  // physical index of logical slot 0 (the oldest)
  float bc = c;
  for (int d = 0; d < D; ++d) bx[d] = x[d];

  for (int it = 0; it < n_iters; ++it) {
    // ---- two-loop recursion ---------------------------------------------------------
    for (int d = 0; d < D; ++d) r[d] = g[d];
    for (int i = m - 1; i >= 0; --i) {
      int ph = (head + i) % m;
      float a = 0.0f;
      if (sc.at(oV + ph) > 0.0f) {
        float sq = 0.0f;
        for (int d = 0; d < D; ++d) sq += sc.at(oS + ph * D + d) * r[d];
        a = sc.at(oRho + ph) * sq;
        for (int d = 0; d < D; ++d) r[d] -= a * sc.at(oY + ph * D + d);
      }
      sc.at(oA + i) = a;
    }
    {
      int ph = (head + m - 1) % m;
      float gamma = 1.0f;
      if (sc.at(oV + ph) > 0.0f) {
        float sy = 0.0f, yy = 0.0f;
        for (int d = 0; d < D; ++d) {
          float yv = sc.at(oY + ph * D + d);
          sy += sc.at(oS + ph * D + d) * yv;
          yy += yv * yv;
        }
        gamma = sy / fmaxf(yy, 1e-10f);
      }
      for (int d = 0; d < D; ++d) r[d] *= gamma;
    }
    for (int i = 0; i < m; ++i) {
      int ph = (head + i) % m;
      if (sc.at(oV + ph) > 0.0f) {
        float yr = 0.0f;
        for (int d = 0; d < D; ++d) yr += sc.at(oY + ph * D + d) * r[d];
        float coef = sc.at(oA + i) - sc.at(oRho + ph) * yr;
        for (int d = 0; d < D; ++d) r[d] += sc.at(oS + ph * D + d) * coef;
      }
    }
    // ---- descent safeguard, max-norm step clamp ----------------------------------------
    float dg = 0.0f;
    for (int d = 0; d < D; ++d) { dvec[d] = -r[d]; dg += dvec[d] * g[d]; }
    if (!(dg < 0.0f))
      for (int d = 0; d < D; ++d) dvec[d] = -g[d];
    float dn = 0.0f;
    for (int d = 0; d < D; ++d) dn = fmaxf(dn, fabsf(dvec[d]));
    float sclamp = fminf(1.0f, max_step / fmaxf(dn, 1e-9f));
    for (int d = 0; d < D; ++d) dvec[d] *= sclamp;
    // ---- line search: best of n_ls candidates, zero step if none is better ---------------
    float best_a = 0.0f, best_lc = c;
    for (int k = 0; k < n_ls; ++k) {
      float alpha = ls_base * expf((float)k * ls_log_ratio);
      for (int d = 0; d < D; ++d) xn[d] = x[d] + alpha * dvec[d];
      ik_clip(rb, xn);
      float ca = ik_eval(rb, w, sc, goal, xn, nullptr, mode, nullptr);
      if (ca < best_lc) { best_a = alpha; best_lc = ca; }
    }
    for (int d = 0; d < D; ++d) xn[d] = x[d] + best_a * dvec[d];
    ik_clip(rb, xn);
    float cn = ik_eval(rb, w, sc, goal, xn, gn, mode | IK_WANT_GRAD, nullptr);
    // ---- history: overwrite the oldest slot, which becomes the newest -------------------
    float sy = 0.0f;
    for (int d = 0; d < D; ++d) sy += (xn[d] - x[d]) * (gn[d] - g[d]);
    bool ok = sy > 1e-10f;
    for (int d = 0; d < D; ++d) {
      sc.at(oS + head * D + d) = ok ? (xn[d] - x[d]) : 0.0f;
      sc.at(oY + head * D + d) = ok ? (gn[d] - g[d]) : 0.0f;
    }
    sc.at(oRho + head) = ok ? 1.0f / fmaxf(sy, 1e-10f) : 0.0f;
    sc.at(oV + head) = ok ? 1.0f : 0.0f;
    head = (head + 1) % m;
    if (cn < bc) {
      bc = cn;
      for (int d = 0; d < D; ++d) bx[d] = xn[d];
    }
    c = cn;
    for (int d = 0; d < D; ++d) { x[d] = xn[d]; g[d] = gn[d]; }
  }
  for (int d = 0; d < D; ++d) x[d] = bx[d];
  return bc;
}

// ---------------------------------------------------------------------------
// Philox 4x32-10, keyed by the seed, counter (config, iteration, particle, j):
// four words make the standard normals of dimensions 2j and 2j+1 (Box-Muller,
// cosine branch, as the TPU kernel draws them).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ik_philox(unsigned int k0, unsigned int k1, unsigned int c0,
                                          unsigned int c1, unsigned int c2, unsigned int c3,
                                          unsigned int* out) {
  for (int r = 0; r < 10; ++r) {
    unsigned int hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    unsigned int hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    unsigned int n0 = hi1 ^ c1 ^ k0, n1 = lo1, n2 = hi0 ^ c3 ^ k1, n3 = lo0;
    c0 = n0; c1 = n1; c2 = n2; c3 = n3;
    k0 += 0x9E3779B9u; k1 += 0xBB67AE85u;
  }
  out[0] = c0; out[1] = c1; out[2] = c2; out[3] = c3;
}

__device__ __forceinline__ float ik_box_muller(unsigned int b1, unsigned int b2) {
  float u1 = (__uint2float_rn(b1) + 0.5f) * 2.3283064365386963e-10f;
  float u2 = (__uint2float_rn(b2) + 0.5f) * 2.3283064365386963e-10f;
  u1 = fminf(fmaxf(u1, 1e-7f), 1.0f - 1e-7f);
  return sqrtf(-2.0f * logf(u1)) * cosf(6.2831853071795865f * u2);
}

__device__ __forceinline__ void ik_normals(unsigned int k0, unsigned int k1, int n, int it, int pi,
                                           int D, float* eps) {
  for (int j = 0; 2 * j < D; ++j) {
    unsigned int o[4];
    ik_philox(k0, k1, (unsigned int)n, (unsigned int)it, (unsigned int)pi, (unsigned int)j, o);
    eps[2 * j] = ik_box_muller(o[0], o[1]);
    if (2 * j + 1 < D) eps[2 * j + 1] = ik_box_muller(o[2], o[3]);
  }
}

// ---------------------------------------------------------------------------
// MPPI: streaming softmax over particles with a running-minimum shift; particle
// 0 of every iteration is the mean itself; after the loop the mean is evaluated
// once more and wins only if strictly better. `noise`, when not null, holds
// pre-drawn standard normals (iters, particles, N, D) used instead of Philox.
// ---------------------------------------------------------------------------
__device__ __noinline__ float ik_mppi(const IKRobot& rb, const IKWorld& w, const IKScratch& sc,
                                      const float* goal, float* x, const IKSolveCfg& cfg,
                                      const float* noise, int N) {
  const int D = rb.D;
  float mean[IK_MAXD], bx[IK_MAXD], xp[IK_MAXD], num[IK_MAXD], eps[IK_MAXD];
  for (int d = 0; d < D; ++d) mean[d] = x[d];
  ik_clip(rb, mean);
  float bc = ik_eval(rb, w, sc, goal, mean, nullptr, 0, nullptr);
  for (int d = 0; d < D; ++d) bx[d] = mean[d];
  float std_ = cfg.init_std;
  const float T = cfg.temperature;
  for (int it = 0; it < cfg.mppi_iters; ++it) {
    float m = 1.0e30f, den = 0.0f;
    for (int d = 0; d < D; ++d) num[d] = 0.0f;
    for (int pi = 0; pi < cfg.n_particles; ++pi) {
      if (noise != nullptr) {
        const float* np_ = noise + (((size_t)it * cfg.n_particles + pi) * N + sc.n) * D;
        for (int d = 0; d < D; ++d) eps[d] = np_[d];
      } else {
        ik_normals(cfg.seed_lo, cfg.seed_hi, sc.n, it, pi, D, eps);
      }
      if (pi == 0) {
        for (int d = 0; d < D; ++d) xp[d] = mean[d];
      } else {
        for (int d = 0; d < D; ++d) xp[d] = mean[d] + std_ * eps[d];
        ik_clip(rb, xp);
      }
      float cp = ik_eval(rb, w, sc, goal, xp, nullptr, 0, nullptr);
      float m_new = fminf(m, cp);
      float scale = expf((m_new - m) / T);
      float wgt = expf((m_new - cp) / T);
      for (int d = 0; d < D; ++d) num[d] = num[d] * scale + wgt * xp[d];
      den = den * scale + wgt;
      if (cp < bc) {
        bc = cp;
        for (int d = 0; d < D; ++d) bx[d] = xp[d];
      }
      m = m_new;
    }
    float dsafe = fmaxf(den, 1e-12f);
    for (int d = 0; d < D; ++d) mean[d] = mean[d] + cfg.step_size * (num[d] / dsafe - mean[d]);
    ik_clip(rb, mean);
    std_ = fmaxf(std_ * cfg.std_decay, cfg.min_std);
  }
  float cm = ik_eval(rb, w, sc, goal, mean, nullptr, 0, nullptr);
  if (cm < bc) {
    bc = cm;
    for (int d = 0; d < D; ++d) bx[d] = mean[d];
  }
  for (int d = 0; d < D; ++d) x[d] = bx[d];
  return bc;
}
