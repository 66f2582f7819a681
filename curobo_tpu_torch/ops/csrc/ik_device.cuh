// Device functions shared by the IK kernels (ik_cost_grad, ik_solve) and the
// trajectory kernels (traj_cost_grad, traj_solve).
//
// Replaces the body of the Pallas IK kernels, `PallasIKCost._cost_fns` and the
// in-kernel optimizer loops `_lbfgs_loop` / `_mppi_loop`
// (curobo_tpu/ops/pallas_ik.py), and the per-step body of `_lane_eval`
// (curobo_tpu/ops/pallas_traj.py).
//
// One warp runs one evaluation (one IK configuration, one trajectory step).
// Its state lives in shared memory, `st` below: link frames, sphere centres,
// sphere cotangents and per-link force and torque accumulators (about 2.6 KB
// for the Franka). The robot and world tables are copied into shared memory
// once per block (`ik_load_tables`); the world rows are compacted to the
// enabled ones in table order as they are copied, which keeps the scene
// query's "first strict minimum in table order" and stops disabled rows from
// costing a branch per sample. A world too large to fit beside the rest (some
// thousands of cuboids) is compacted the same way once per launch into global
// memory instead, and read there (ik_world_fits). The work of an evaluation
// is split over the 32 lanes:
//   - FK forward: a serial sweep over the links, lanes 0..11 computing one
//     entry each of the link's rotation and origin;
//   - sphere centres, the self-collision pairs and the scene samples: lane l
//     owns spheres l, l + 32, ...; a sphere's live pairs come from a host-built
//     list of both directions (cost counted at the lower-index end), and its K
//     sweep samples stay on its lane, so that its cotangent is summed in one
//     place;
//   - sphere -> link wrenches: lane l owns links l, l + 32, ..., walking the
//     link's sphere list;
//   - pose error: every lane computes each tool frame's error (IK: 1..IK_MAXT
//     frames, summed; the trajectory kernels: rb.tool[0] only); lane 0 keeps
//     the per-tool terms of the gradient in the warp's goal slot;
//   - FK reverse: a serial sweep over the links on lane 0 (links are numbered
//     parents first, so one sweep from the last link down reaches every
//     branch of a tree such as the dual arm's);
//   - cost and metric sums: warp shuffles in a fixed order.
// Every sum runs in a fixed order and there are no atomics, so a launch gives
// the same bits every time (the planner's "same seed -> same plan").
//
// The FK reverse pass is written by hand: cotangents on sphere centres and on
// the tool pose become a force and a torque (about the world origin) on their
// link, one sweep from the leaves to the root adds them into the parents, and
// d/dq of a revolute joint is mult * axis_world . (torque about the joint
// origin), of a prismatic joint mult * axis_world . force.
//
// Arithmetic is fp32 with IEEE division and sqrt; there are no matrix
// products big enough for tensor cores, and TF32 is not used anywhere.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define IK_MAXD 16         // most degrees of freedom (lane d owns dof d)
#define IK_MAXT 4          // most tool frames of an IK goal (IK_MAXT in ops/ik_kernels.py)
#define IK_FULL 0xffffffffu
// An IK warp's goal slot in shared memory: the goal, 7 words per tool frame
// (position, quaternion), then IK_TERR_WORDS of scratch for the per-tool pose
// errors that the gradient pass reads (ik_eval).
#define IK_GOAL_WORDS (((7 * IK_MAXT) + 3) & ~3)
#define IK_TERR_WORDS (6 * IK_MAXT)

// ---- tables (mirrored by ctypes structures in ops/ik_kernels.py) ----------
struct IKRobot {
  const int* link_i;    // (L, 3)  kind (0 const, 1 revolute, 2 prismatic), parent, dof
  const float* link_f;  // (L, 17) mult, off, R[9] row-major, p[3], axis[3]
  const float* sph_f;   // (S, 4)  centre in link frame, radius (< 0 = disabled)
  const int* sph_link;  // (S,)
  const int* pair_off;  // (S + 1,) sphere s's live pairs are entries [off[s], off[s+1])
  const int* pair_j;    // (2 P,)  the partner sphere of each entry, in pair order
  const float* pair_m;  // (2 P,)  its margin
  const int* lsph_off;  // (L + 1,) link l's live spheres are entries [off[l], off[l+1])
  const int* lsph;      // (n_lsph,) sphere indices, ascending within a link
  const float* dof_f;   // (D, 6)  lim_lo, lim_hi, clip_lo, clip_hi, retract, null_w
  const float* cfg_f;   // (8,)    pos_w, rot_w, bound_w, null_space_w, sc_w, sc_act, coll_w, coll_act
  int L, S, P, D, n_lsph;
  int n_tools;          // 1..IK_MAXT; the trajectory kernels take tool[0] only
  int tool[IK_MAXT];    // link index of each tool frame, in goal order
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

#define IK_WANT_GRAD 1
#define IK_POSE_ONLY 2
#define IK_METRICS 4

// ---- shared-memory layouts, in 4-byte words ---------------------------------
// Robot tables, then the world rows (the enabled ones, at most all).
__host__ __device__ inline int ik_robot_words(const IKRobot& r) {
  return 3 * r.L + 17 * r.L + 4 * r.S + r.S + (r.S + 1) + 4 * r.P + (r.L + 1) + r.n_lsph +
         6 * r.D + 8;
}
__host__ __device__ inline int ik_world_words(const IKWorld& w) {
  return 16 * w.Kc + 5 * w.Ks + 8 * w.Kp + 15 * w.Ky;
}

// State of one evaluation: link frames R (9 L) and origins P (3 L), force F and
// torque T accumulators (3 L each), sphere centres C and cotangents G (3 S
// each), the configuration q and its gradient (IK_MAXD each).
struct IKLayout {
  int oR, oP, oF, oT, oC, oG, oQ, oGQ, words;
};

__host__ __device__ inline IKLayout ik_layout(int L, int S) {
  IKLayout o;
  o.oR = 0; o.oP = 9 * L; o.oF = 12 * L; o.oT = 15 * L; o.oC = 18 * L; o.oG = 18 * L + 3 * S;
  o.oQ = 18 * L + 6 * S; o.oGQ = o.oQ + IK_MAXD; o.words = o.oGQ + IK_MAXD;
  return o;
}

// sign with sign(0) = 0 (copysignf would give +-1 at 0)
__device__ __forceinline__ float ik_sign(float v) {
  return (v > 0.0f) ? 1.0f : ((v < 0.0f) ? -1.0f : 0.0f);
}

__device__ __forceinline__ int ik_lane() { return threadIdx.x & 31; }

// Warp reductions: every lane returns the same value, combined in the same
// order on every call.
__device__ __forceinline__ float ik_warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(IK_FULL, v, o);
  return v;
}
__device__ __forceinline__ float ik_warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(IK_FULL, v, o));
  return v;
}
__device__ __forceinline__ float ik_warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(IK_FULL, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// Tables into shared memory, once per block
// ---------------------------------------------------------------------------
__device__ __forceinline__ const void* ik_copy_words(float*& p, const void* src, int n) {
  const unsigned* s = (const unsigned*)src;
  unsigned* d = (unsigned*)p;
  for (int i = threadIdx.x; i < n; i += blockDim.x) d[i] = s[i];
  p += n;
  return d;
}

// The enabled rows of a (K, width) table (flag in the last column), in table
// order, to dst; run by the 32 lanes of one warp, a ballot per 32 rows.
__device__ __forceinline__ int ik_compact_rows(float* dst, const float* src, int K, int width) {
  const int lane = ik_lane();
  int base = 0;
  for (int r0 = 0; r0 < K; r0 += 32) {
    const int r = r0 + lane;
    const bool en = r < K && src[(size_t)r * width + width - 1] > 0.5f;
    const unsigned mask = __ballot_sync(IK_FULL, en);
    if (en) {
      const int pos = base + __popc(mask & ((1u << lane) - 1u));
      for (int e = 0; e < width; ++e) dst[pos * width + e] = src[(size_t)r * width + e];
    }
    base += __popc(mask);
  }
  return base;
}

// Copies the robot tables and the enabled world rows into shared memory at
// `smem` and returns the first word after them. `rb` and `w` are the block's
// descriptors of the copies, themselves in (static) shared memory, so that
// their pointers are read where they are used instead of holding some 40
// registers for the whole kernel. A world too large for shared memory comes
// already compacted in global memory, `wglob` (ik_compact_world_kernel): its
// rows are then read there and not copied. Every thread of the block must call
// it (it ends with a barrier).
__device__ float* ik_load_tables(const IKRobot& g, const IKWorld& gw, const float* wglob,
                                 float* smem, IKRobot& rb, IKWorld& w) {
  float* p = smem;
  const int* link_i = (const int*)ik_copy_words(p, g.link_i, 3 * g.L);
  const float* link_f = (const float*)ik_copy_words(p, g.link_f, 17 * g.L);
  const float* sph_f = (const float*)ik_copy_words(p, g.sph_f, 4 * g.S);
  const int* sph_link = (const int*)ik_copy_words(p, g.sph_link, g.S);
  const int* pair_off = (const int*)ik_copy_words(p, g.pair_off, g.S + 1);
  const int* pair_j = (const int*)ik_copy_words(p, g.pair_j, 2 * g.P);
  const float* pair_m = (const float*)ik_copy_words(p, g.pair_m, 2 * g.P);
  const int* lsph_off = (const int*)ik_copy_words(p, g.lsph_off, g.L + 1);
  const int* lsph = (const int*)ik_copy_words(p, g.lsph, g.n_lsph);
  const float* dof_f = (const float*)ik_copy_words(p, g.dof_f, 6 * g.D);
  const float* cfg_f = (const float*)ik_copy_words(p, g.cfg_f, 8);
  // the four tables at the offsets of their capacities
  const int oS = 16 * gw.Kc, oP = oS + 5 * gw.Ks, oY = oP + 8 * gw.Kp;
  const float* cub = wglob != nullptr ? wglob + 4 : p;
  const float* sph = cub + oS;
  const float* cap = cub + oP;
  const float* cyl = cub + oY;
  if (threadIdx.x < 32) {
    int kc, ks, kp, ky;
    if (wglob != nullptr) {
      const int* n = (const int*)wglob;
      kc = n[0]; ks = n[1]; kp = n[2]; ky = n[3];
    } else {
      kc = ik_compact_rows(p, gw.cub, gw.Kc, 16);
      ks = ik_compact_rows(p + oS, gw.sph, gw.Ks, 5);
      kp = ik_compact_rows(p + oP, gw.cap, gw.Kp, 8);
      ky = ik_compact_rows(p + oY, gw.cyl, gw.Ky, 15);
    }
    if (threadIdx.x == 0) {
      rb = g;
      rb.link_i = link_i; rb.link_f = link_f; rb.sph_f = sph_f; rb.sph_link = sph_link;
      rb.pair_off = pair_off; rb.pair_j = pair_j; rb.pair_m = pair_m;
      rb.lsph_off = lsph_off; rb.lsph = lsph; rb.dof_f = dof_f; rb.cfg_f = cfg_f;
      w.cub = cub; w.sph = sph; w.cap = cap; w.cyl = cyl;
      w.Kc = kc; w.Ks = ks; w.Kp = kp; w.Ky = ky;
    }
  }
  __syncthreads();
  return wglob != nullptr ? p : p + ik_world_words(gw);
}

// The enabled world rows compacted in table order into `dst` in global memory:
// the four counts, then the four tables at the offsets of their capacities.
// Launched with one warp before a kernel whose world does not fit in shared
// memory (ik_world_fits), which then reads the rows there.
__global__ void ik_compact_world_kernel(IKWorld gw, float* dst) {
  const int oS = 16 * gw.Kc, oP = oS + 5 * gw.Ks, oY = oP + 8 * gw.Kp;
  float* rows = dst + 4;
  const int kc = ik_compact_rows(rows, gw.cub, gw.Kc, 16);
  const int ks = ik_compact_rows(rows + oS, gw.sph, gw.Ks, 5);
  const int kp = ik_compact_rows(rows + oP, gw.cap, gw.Kp, 8);
  const int ky = ik_compact_rows(rows + oY, gw.cyl, gw.Ky, 15);
  if (threadIdx.x == 0) {
    int* n = (int*)dst;
    n[0] = kc; n[1] = ks; n[2] = kp; n[3] = ky;
  }
}

// ---- launch-side helpers ----------------------------------------------------
// Shared memory a block may have on this device, in 4-byte words.
static inline size_t ik_smem_limit_words() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)v / sizeof(float);
}

// Whether the world rows fit in a block's shared memory next to the robot
// tables and `other` words of the block's own state. When they do not, the
// launch compacts them into a global buffer of ik_world_global_words words
// (ik_stage_world) and the kernels read them there; nothing else changes.
static inline bool ik_world_fits(const IKRobot& r, const IKWorld& w, size_t other) {
  return (size_t)ik_robot_words(r) + (size_t)ik_world_words(w) + other <= ik_smem_limit_words();
}
static inline int ik_world_global_words(const IKWorld& w) { return 4 + ik_world_words(w); }

// Compacts the world into `buf` on `stream` when it goes to global memory and
// returns the pointer the kernel takes (null for a world in shared memory);
// *err gets the CUDA error (cudaErrorInvalidValue without a buffer).
static inline const float* ik_stage_world(const IKWorld& w, bool fits, float* buf,
                                          cudaStream_t stream, int* err) {
  *err = 0;
  if (fits) return nullptr;
  if (buf == nullptr) {
    *err = (int)cudaErrorInvalidValue;
    return nullptr;
  }
  ik_compact_world_kernel<<<1, 32, 0, stream>>>(w, buf);
  *err = (int)cudaGetLastError();
  return buf;
}

// ---------------------------------------------------------------------------
// Min signed distance of one point over the four (compacted, all enabled)
// obstacle tables, first strict minimum in table order (cuboid, sphere,
// capsule, cylinder), 1e6 when there is none; `arg` gets the winner as
// (table << 24) | row, or -1. The scan computes distances only; the gradient
// of the winner (`ik_scene_grad`) is taken afterwards where a caller needs it,
// from the same expressions, so it is the gradient of the argmin obstacle.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float ik_cuboid_dist(const float* r, float x, float y, float z,
                                                float* l, float* q, float& o) {
  float ux = x - r[9], uy = y - r[10], uz = z - r[11];
  l[0] = r[0] * ux + r[3] * uy + r[6] * uz;
  l[1] = r[1] * ux + r[4] * uy + r[7] * uz;
  l[2] = r[2] * ux + r[5] * uy + r[8] * uz;
  q[0] = fabsf(l[0]) - r[12]; q[1] = fabsf(l[1]) - r[13]; q[2] = fabsf(l[2]) - r[14];
  float mqx = fmaxf(q[0], 0.0f), mqy = fmaxf(q[1], 0.0f), mqz = fmaxf(q[2], 0.0f);
  o = sqrtf(mqx * mqx + mqy * mqy + mqz * mqz + 1e-12f);
  return o + fminf(fmaxf(q[0], fmaxf(q[1], q[2])), 0.0f);
}

__device__ __forceinline__ float ik_capsule_dist(const float* r, float x, float y, float z,
                                                 float* u, float& n) {
  float denom = fmaxf(r[3] * r[3] + r[4] * r[4] + r[5] * r[5], 1e-12f);
  float px = x - r[0], py = y - r[1], pz = z - r[2];
  float h = fminf(fmaxf((px * r[3] + py * r[4] + pz * r[5]) / denom, 0.0f), 1.0f);
  u[0] = px - r[3] * h; u[1] = py - r[4] * h; u[2] = pz - r[5] * h;
  n = sqrtf(u[0] * u[0] + u[1] * u[1] + u[2] * u[2] + 1e-12f);
  return n - r[6];
}

__device__ __forceinline__ float ik_cylinder_dist(const float* r, float x, float y, float z,
                                                  float* l, float& rad, float& dr, float& dz,
                                                  float& o) {
  float ux = x - r[9], uy = y - r[10], uz = z - r[11];
  l[0] = r[0] * ux + r[3] * uy + r[6] * uz;
  l[1] = r[1] * ux + r[4] * uy + r[7] * uz;
  l[2] = r[2] * ux + r[5] * uy + r[8] * uz;
  rad = sqrtf(l[0] * l[0] + l[1] * l[1] + 1e-12f);
  dr = rad - r[12];
  dz = fabsf(l[2]) - r[13];
  float mdr = fmaxf(dr, 0.0f), mdz = fmaxf(dz, 0.0f);
  o = sqrtf(mdr * mdr + mdz * mdz + 1e-12f);
  return o + fminf(fmaxf(dr, dz), 0.0f);
}

__device__ __forceinline__ float ik_scene_msdf(const IKWorld& w, float x, float y, float z,
                                               int& arg) {
  float md = 1.0e6f;
  arg = -1;
  for (int k = 0; k < w.Kc; ++k) {
    float l[3], q[3], o;
    float d = ik_cuboid_dist(w.cub + 16 * k, x, y, z, l, q, o);
    if (d < md) { md = d; arg = k; }
  }
  for (int k = 0; k < w.Ks; ++k) {
    const float* r = w.sph + 5 * k;
    float ux = x - r[0], uy = y - r[1], uz = z - r[2];
    float d = sqrtf(ux * ux + uy * uy + uz * uz + 1e-12f) - r[3];
    if (d < md) { md = d; arg = (1 << 24) | k; }
  }
  for (int k = 0; k < w.Kp; ++k) {
    float u[3], n;
    float d = ik_capsule_dist(w.cap + 8 * k, x, y, z, u, n);
    if (d < md) { md = d; arg = (2 << 24) | k; }
  }
  for (int k = 0; k < w.Ky; ++k) {
    float l[3], rad, dr, dz, o;
    float d = ik_cylinder_dist(w.cyl + 15 * k, x, y, z, l, rad, dr, dz, o);
    if (d < md) { md = d; arg = (3 << 24) | k; }
  }
  return md;
}

// The analytic gradient of the signed distance of obstacle `arg` (as set by
// ik_scene_msdf) at (x, y, z); zero for -1.
__device__ __forceinline__ void ik_scene_grad(const IKWorld& w, int arg, float x, float y,
                                              float z, float& g0, float& g1, float& g2) {
  g0 = g1 = g2 = 0.0f;
  if (arg < 0) return;
  const int table = arg >> 24, k = arg & 0xffffff;
  if (table == 0) {
    const float* r = w.cub + 16 * k;
    float l[3], q[3], o;
    ik_cuboid_dist(r, x, y, z, l, q, o);
    float sx = ik_sign(l[0]), sy = ik_sign(l[1]), sz = ik_sign(l[2]);
    float glx, gly, glz;
    if (fmaxf(q[0], fmaxf(q[1], q[2])) > 0.0f) {
      glx = sx * fmaxf(q[0], 0.0f) / o; gly = sy * fmaxf(q[1], 0.0f) / o; glz = sz * fmaxf(q[2], 0.0f) / o;
    } else {
      bool ax = (q[0] >= q[1]) && (q[0] >= q[2]);
      bool ay = (!ax) && (q[1] >= q[2]);
      bool az = !(ax || ay);
      glx = ax ? sx : 0.0f; gly = ay ? sy : 0.0f; glz = az ? sz : 0.0f;
    }
    g0 = r[0] * glx + r[1] * gly + r[2] * glz;
    g1 = r[3] * glx + r[4] * gly + r[5] * glz;
    g2 = r[6] * glx + r[7] * gly + r[8] * glz;
  } else if (table == 1) {
    const float* r = w.sph + 5 * k;
    float ux = x - r[0], uy = y - r[1], uz = z - r[2];
    float n = sqrtf(ux * ux + uy * uy + uz * uz + 1e-12f);
    g0 = ux / n; g1 = uy / n; g2 = uz / n;
  } else if (table == 2) {
    float u[3], n;
    ik_capsule_dist(w.cap + 8 * k, x, y, z, u, n);
    g0 = u[0] / n; g1 = u[1] / n; g2 = u[2] / n;
  } else {
    const float* r = w.cyl + 15 * k;
    float l[3], rad, dr, dz, o;
    ik_cylinder_dist(r, x, y, z, l, rad, dr, dz, o);
    float rx = l[0] / rad, ry = l[1] / rad, sz = ik_sign(l[2]);
    float glx, gly, glz;
    if (fmaxf(dr, dz) > 0.0f) {
      glx = fmaxf(dr, 0.0f) * rx / o; gly = fmaxf(dr, 0.0f) * ry / o; glz = fmaxf(dz, 0.0f) * sz / o;
    } else {
      bool radial = dr >= dz;
      glx = radial ? rx : 0.0f; gly = radial ? ry : 0.0f; glz = radial ? 0.0f : sz;
    }
    g0 = r[0] * glx + r[1] * gly + r[2] * glz;
    g1 = r[3] * glx + r[4] * gly + r[5] * glz;
    g2 = r[6] * glx + r[7] * gly + r[8] * glz;
  }
}

// ---------------------------------------------------------------------------
// Pieces of one evaluation, run by the 32 lanes of a warp on its state `st`
// (layout `ik_layout`). Each ends with the warp's writes visible to all lanes.
// ---------------------------------------------------------------------------

// Link frames from q (st[oQ + dof]): a serial sweep over the links; lanes
// 0..8 compute one entry of the link's rotation, lanes 9..11 one of its origin.
__device__ __forceinline__ void ik_fk_forward(const IKRobot& rb, float* st, const IKLayout& o) {
  const int lane = ik_lane();
  for (int i = 0; i < rb.L; ++i) {
    if (lane < 12) {
      const int kind = rb.link_i[3 * i], par = rb.link_i[3 * i + 1], dof = rb.link_i[3 * i + 2];
      const float* lf = rb.link_f + 17 * i;
      float Rl[9], pl[3];
      if (kind == 1) {
        float val = lf[0] * st[o.oQ + dof] + lf[1];
        float s, c;
        sincosf(val, &s, &c);
        float ax = lf[14], ay = lf[15], az = lf[16], omc = 1.0f - c;
        float r[9] = {c + omc * ax * ax,      omc * ax * ay - s * az, omc * ax * az + s * ay,
                      omc * ax * ay + s * az, c + omc * ay * ay,      omc * ay * az - s * ax,
                      omc * ax * az - s * ay, omc * ay * az + s * ax, c + omc * az * az};
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b)
            Rl[3 * a + b] = lf[2 + 3 * a] * r[b] + lf[2 + 3 * a + 1] * r[3 + b] + lf[2 + 3 * a + 2] * r[6 + b];
        pl[0] = lf[11]; pl[1] = lf[12]; pl[2] = lf[13];
      } else {
#pragma unroll
        for (int a = 0; a < 9; ++a) Rl[a] = lf[2 + a];
        pl[0] = lf[11]; pl[1] = lf[12]; pl[2] = lf[13];
        if (kind == 2) {
          float val = lf[0] * st[o.oQ + dof] + lf[1];
          float ax = lf[14] * val, ay = lf[15] * val, az = lf[16] * val;
#pragma unroll
          for (int a = 0; a < 3; ++a)
            pl[a] += lf[2 + 3 * a] * ax + lf[2 + 3 * a + 1] * ay + lf[2 + 3 * a + 2] * az;
        }
      }
      if (lane < 9) {
        const int a = lane / 3, b = lane - 3 * (lane / 3);
        // column b of Rl, selected without indexing a register array
        float c0 = Rl[0], c1 = Rl[3], c2 = Rl[6];
        if (b == 1) { c0 = Rl[1]; c1 = Rl[4]; c2 = Rl[7]; }
        if (b == 2) { c0 = Rl[2]; c1 = Rl[5]; c2 = Rl[8]; }
        float v;
        if (par < 0) {
          v = (a == 0) ? c0 : ((a == 1) ? c1 : c2);
        } else {
          const float* Rp = st + o.oR + 9 * par + 3 * a;
          v = Rp[0] * c0 + Rp[1] * c1 + Rp[2] * c2;
        }
        st[o.oR + 9 * i + lane] = v;
      } else {
        const int a = lane - 9;
        float v;
        if (par < 0) {
          v = (a == 0) ? pl[0] : ((a == 1) ? pl[1] : pl[2]);
        } else {
          const float* Rp = st + o.oR + 9 * par + 3 * a;
          v = st[o.oP + 3 * par + a] + Rp[0] * pl[0] + Rp[1] * pl[1] + Rp[2] * pl[2];
        }
        st[o.oP + 3 * i + a] = v;
      }
    }
    __syncwarp();
  }
}

// Sphere centres, lane l owning spheres l, l + 32, ...
__device__ __forceinline__ void ik_centres(const IKRobot& rb, float* st, const IKLayout& o) {
  for (int si = ik_lane(); si < rb.S; si += 32) {
    const float* sf = rb.sph_f + 4 * si;
    const int li = rb.sph_link[si];
    const float* R = st + o.oR + 9 * li;
    const float* P = st + o.oP + 3 * li;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      st[o.oC + 3 * si + a] = R[3 * a] * sf[0] + R[3 * a + 1] * sf[1] + R[3 * a + 2] * sf[2] + P[a];
  }
  __syncwarp();
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

// Self-collision hinge and (swept) scene term of the spheres this lane owns.
// Step h's scene samples run from the previous step's centres (its state at
// st + prev, `prev` words away; IK passes 0) to its own, K samples with the
// last at its own centres (IK: K = 1). Returns the lane's share of
// sc_w * hinge + coll_w * scene. With want_grad it writes every owned sphere's
// cotangent G and, where oGp >= 0, the cotangent on the previous step's centre
// at st + oGp (the sweep samples add into the owner lane's shared slots, which
// keeps them out of registers); with metrics it folds the pair violations into
// self_viol and the last sample's clearances into min_clear. Offsets rather
// than pointers keep the loop's registers down.
__device__ __forceinline__ float ik_sphere_terms(const IKRobot& rb, const IKWorld& w, float* st,
                                                 const IKLayout& o, int prev, int K,
                                                 bool speed_metric, bool want_grad, int oGp,
                                                 bool metrics, float& self_viol, float& min_clear) {
  const float sc_w = rb.cfg_f[4], sc_act = rb.cfg_f[5];
  const float coll_w = rb.cfg_f[6], coll_act = rb.cfg_f[7];
  const float ct_base = -coll_w / (float)K;
  float part = 0.0f;
  for (int si = ik_lane(); si < rb.S; si += 32) {
    const float sx = st[o.oC + 3 * si], sy = st[o.oC + 3 * si + 1], sz = st[o.oC + 3 * si + 2];
    float gx = 0.0f, gy = 0.0f, gz = 0.0f;
    // ---- self collision: this sphere's live pairs, cost at the lower index --
    float hinge = 0.0f;
    for (int k = rb.pair_off[si]; k < rb.pair_off[si + 1]; ++k) {
      const int t = rb.pair_j[k];
      const float m = rb.pair_m[k];
      float ddx = sx - st[o.oC + 3 * t];
      float ddy = sy - st[o.oC + 3 * t + 1];
      float ddz = sz - st[o.oC + 3 * t + 2];
      float dist = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz + 1e-12f);
      float h = m + sc_act - dist;
      if (h > 0.0f) {
        if (si < t) hinge += h;
        if (want_grad) {
          float cf = -sc_w / dist;
          gx += cf * ddx; gy += cf * ddy; gz += cf * ddz;
        }
      }
      if (metrics) self_viol = fmaxf(self_viol, m - dist);
    }
    part += sc_w * hinge;
    const int g = o.oG + 3 * si, gp = oGp + 3 * si;
    if (want_grad) {
      st[g] = gx; st[g + 1] = gy; st[g + 2] = gz;
      if (oGp >= 0) { st[gp] = 0.0f; st[gp + 1] = 0.0f; st[gp + 2] = 0.0f; }
    }
    // ---- scene: K samples from the previous step's centre to this one --------
    const float rad = rb.sph_f[4 * si + 3];
    if (rad >= 0.0f) {
      const int c = prev + o.oC + 3 * si;
      const float px = st[c], py = st[c + 1], pz = st[c + 2];
      float spd = 1.0f, nrm = 1.0f;
      if (speed_metric) {
        float ex = sx - px, ey = sy - py, ez = sz - pz;
        nrm = sqrtf(ex * ex + ey * ey + ez * ez + 1e-12f);
        spd = nrm + 1e-3f;
      }
      float pen = 0.0f;
      for (int k = 1; k <= K; ++k) {
        const float alpha = (float)((double)k / (double)K);
        const float om = (float)(1.0 - (double)k / (double)K);
        const float qx = px * om + sx * alpha, qy = py * om + sy * alpha, qz = pz * om + sz * alpha;
        int arg;
        const float msdf = ik_scene_msdf(w, qx, qy, qz, arg);
        const float viol = coll_act + rad - msdf;
        pen += fmaxf(0.0f, viol);
        if (want_grad && viol > 0.0f) {
          float g0, g1, g2;
          ik_scene_grad(w, arg, qx, qy, qz, g0, g1, g2);
          const float ct = ct_base * spd;
          st[g] += alpha * ct * g0; st[g + 1] += alpha * ct * g1; st[g + 2] += alpha * ct * g2;
          if (oGp >= 0) {
            st[gp] += om * ct * g0; st[gp + 1] += om * ct * g1; st[gp + 2] += om * ct * g2;
          }
        }
        if (metrics && k == K) min_clear = fminf(min_clear, msdf - rad);
      }
      pen = pen / (float)K;
      part += coll_w * (pen * spd);
      if (want_grad && speed_metric) {
        const float cspd = coll_w * pen / nrm;
        st[g] += cspd * (sx - px); st[g + 1] += cspd * (sy - py); st[g + 2] += cspd * (sz - pz);
        if (oGp >= 0) {
          st[gp] -= cspd * (sx - px); st[gp + 1] -= cspd * (sy - py); st[gp + 2] -= cspd * (sz - pz);
        }
      }
    }
  }
  return part;
}

// The force and torque (about the world origin) on a tool link from the
// cotangent of pos_w * pe2 + rot_w * re2: a force on the tool origin and a pure
// torque; (dx, dy, dz) is goal - tool, e the rotation vector of the error.
__device__ __forceinline__ void ik_tool_wrench(const float* Rt, const float* tp, float pos_w,
                                               float rot_w, float dx, float dy, float dz,
                                               float ex, float ey, float ez, float* W) {
  const float F0 = -2.0f * pos_w * dx, F1 = -2.0f * pos_w * dy, F2 = -2.0f * pos_w * dz;
  const float k = 2.0f * rot_w;
  const float tx = k * (Rt[0] * ex + Rt[1] * ey + Rt[2] * ez);
  const float ty = k * (Rt[3] * ex + Rt[4] * ey + Rt[5] * ez);
  const float tz = k * (Rt[6] * ex + Rt[7] * ey + Rt[8] * ez);
  W[0] = F0; W[1] = F1; W[2] = F2;
  W[3] = tx + tp[1] * F2 - tp[2] * F1;
  W[4] = ty + tp[2] * F0 - tp[0] * F2;
  W[5] = tz + tp[0] * F1 - tp[1] * F0;
}

// Adds the cotangents of link l's live spheres, in sphere order, to its force
// F and torque T.
__device__ __forceinline__ void ik_sphere_wrench(const IKRobot& rb, const float* st,
                                                 const IKLayout& o, int l, float* W) {
  for (int k = rb.lsph_off[l]; k < rb.lsph_off[l + 1]; ++k) {
    const int si = rb.lsph[k];
    float fx = st[o.oG + 3 * si], fy = st[o.oG + 3 * si + 1], fz = st[o.oG + 3 * si + 2];
    if (fx == 0.0f && fy == 0.0f && fz == 0.0f) continue;
    float cx = st[o.oC + 3 * si], cy = st[o.oC + 3 * si + 1], cz = st[o.oC + 3 * si + 2];
    W[0] += fx; W[1] += fy; W[2] += fz;
    W[3] += cy * fz - cz * fy;
    W[4] += cz * fx - cx * fz;
    W[5] += cx * fy - cy * fx;
  }
}

__device__ __forceinline__ void ik_store_wrench(float* st, const IKLayout& o, int l,
                                                const float* W) {
  st[o.oF + 3 * l] = W[0]; st[o.oF + 3 * l + 1] = W[1]; st[o.oF + 3 * l + 2] = W[2];
  st[o.oT + 3 * l] = W[3]; st[o.oT + 3 * l + 1] = W[4]; st[o.oT + 3 * l + 2] = W[5];
}

// Per-link force and torque (about the world origin) for one tool frame,
// rb.tool[0] (the trajectory kernels): lane l owns links l, l + 32, ...; the
// tool link starts from the pose error's cotangent when `tool_on`, then every
// link adds the cotangents of its live spheres (when `spheres`).
__device__ __forceinline__ void ik_wrenches(const IKRobot& rb, float* st, const IKLayout& o,
                                            bool tool_on, float pos_w, float rot_w,
                                            const IKPoseErr& e, bool spheres) {
  for (int l = ik_lane(); l < rb.L; l += 32) {
    float W[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (tool_on && l == rb.tool[0])
      ik_tool_wrench(st + o.oR + 9 * l, st + o.oP + 3 * l, pos_w, rot_w, e.dx, e.dy, e.dz,
                     e.rx * e.scale, e.ry * e.scale, e.rz * e.scale, W);
    if (spheres) ik_sphere_wrench(rb, st, o, l, W);
    ik_store_wrench(st, o, l, W);
  }
  __syncwarp();
}

// The same over all rb.n_tools tool frames (the IK kernels): tool t's error is
// (dx, dy, dz, ex, ey, ez) at terr[6 t]; a link that carries several tool
// frames adds their wrenches in tool order.
__device__ __forceinline__ void ik_wrenches_tools(const IKRobot& rb, float* st, const IKLayout& o,
                                                  const float* terr, float pos_w, float rot_w,
                                                  bool spheres) {
  for (int l = ik_lane(); l < rb.L; l += 32) {
    float W[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int t = 0; t < rb.n_tools; ++t) {
      if (rb.tool[t] != l) continue;
      const float* e = terr + 6 * t;
      float Wt[6];
      ik_tool_wrench(st + o.oR + 9 * l, st + o.oP + 3 * l, pos_w, rot_w, e[0], e[1], e[2],
                     e[3], e[4], e[5], Wt);
#pragma unroll
      for (int a = 0; a < 6; ++a) W[a] += Wt[a];
    }
    if (spheres) ik_sphere_wrench(rb, st, o, l, W);
    ik_store_wrench(st, o, l, W);
  }
  __syncwarp();
}

// Reverse sweep, leaves to root, on lane 0: the accumulated wrenches become
// d/dq, added into grad (which holds the direct terms already).
__device__ __forceinline__ void ik_fk_reverse(const IKRobot& rb, float* st, const IKLayout& o,
                                              float* grad) {
  if (ik_lane() == 0) {
    for (int i = rb.L - 1; i >= 0; --i) {
      const int kind = rb.link_i[3 * i], par = rb.link_i[3 * i + 1], dof = rb.link_i[3 * i + 2];
      float F[3], T[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) { F[a] = st[o.oF + 3 * i + a]; T[a] = st[o.oT + 3 * i + a]; }
      if (kind != 0) {
        const float* lf = rb.link_f + 17 * i;
        const float* R = st + o.oR + 9 * i;
        float aw[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) aw[a] = R[3 * a] * lf[14] + R[3 * a + 1] * lf[15] + R[3 * a + 2] * lf[16];
        float g;
        if (kind == 1) {
          float px = st[o.oP + 3 * i], py = st[o.oP + 3 * i + 1], pz = st[o.oP + 3 * i + 2];
          float qx = T[0] - (py * F[2] - pz * F[1]);
          float qy = T[1] - (pz * F[0] - px * F[2]);
          float qz = T[2] - (px * F[1] - py * F[0]);
          g = aw[0] * qx + aw[1] * qy + aw[2] * qz;
        } else {
          g = aw[0] * F[0] + aw[1] * F[1] + aw[2] * F[2];
        }
        grad[dof] += lf[0] * g;
      }
      if (par >= 0) {
#pragma unroll
        for (int a = 0; a < 3; ++a) { st[o.oF + 3 * par + a] += F[a]; st[o.oT + 3 * par + a] += T[a]; }
      }
    }
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// The IK objective of one configuration, on one warp: FK, pose error,
// joint-limit and null-space penalties, self-collision hinge, scene penalty;
// with IK_WANT_GRAD its gradient by the hand-written reverse pass; with
// IK_METRICS the raw quantities of the feasibility test. Lane d < D holds x_d
// and receives g_d; `goal` is the warp's goal slot in shared memory: 7 words
// per tool frame, then (at goal + IK_GOAL_WORDS) the per-tool error scratch.
// The pose cost is summed over the tool frames and the metrics keep each
// error's largest value over them. Returns the cost on every lane.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float ik_eval(const IKRobot& rb, const IKWorld& w, float* st,
                                      float* goal, float x, float& g, int flags,
                                      IKMetrics* met) {
  const bool want_grad = (flags & IK_WANT_GRAD) != 0;
  const bool pose_only = (flags & IK_POSE_ONLY) != 0;
  const bool metrics = (flags & IK_METRICS) != 0;
  const int lane = ik_lane(), D = rb.D;
  const IKLayout o = ik_layout(rb.L, rb.S);
  const float pos_w = rb.cfg_f[0], rot_w = rb.cfg_f[1], bound_w = rb.cfg_f[2];
  const float null_w = rb.cfg_f[3];

  if (lane < D) st[o.oQ + lane] = x;
  __syncwarp();
  ik_fk_forward(rb, st, o);
  // pose error of every tool frame: the cost sums them, the metrics keep the
  // largest, the gradient pass reads each tool's (d, e) from shared memory
  float* terr = goal + IK_GOAL_WORDS;
  float cpose = 0.0f, pe2_max = 0.0f, re2_max = 0.0f;
  for (int t = 0; t < rb.n_tools; ++t) {
    const int tl = rb.tool[t];
    const IKPoseErr pe = ik_pose_error(goal + 7 * t, st + o.oR + 9 * tl, st + o.oP + 3 * tl);
    cpose += pos_w * pe.pe2 + rot_w * pe.re2;
    pe2_max = fmaxf(pe2_max, pe.pe2);
    re2_max = fmaxf(re2_max, pe.re2);
    if (want_grad && lane == 0) {
      float* e = terr + 6 * t;
      e[0] = pe.dx; e[1] = pe.dy; e[2] = pe.dz;
      e[3] = pe.rx * pe.scale; e[4] = pe.ry * pe.scale; e[5] = pe.rz * pe.scale;
    }
  }

  // ---- joint limits + null space: lane d, dof d -------------------------------
  float part = 0.0f, gd = 0.0f;
  if (lane < D) {
    const float* df = rb.dof_f + 6 * lane;
    float lo_v = fmaxf(df[0] - x, 0.0f), hi_v = fmaxf(x - df[1], 0.0f);
    float viol = lo_v + hi_v;
    part = bound_w * viol * viol;
    gd = 2.0f * bound_w * viol * ((hi_v > 0.0f ? 1.0f : 0.0f) - (lo_v > 0.0f ? 1.0f : 0.0f));
    if (null_w > 0.0f) {
      float dn = (x - df[4]) * df[5];
      part += null_w * dn * dn;
      gd += 2.0f * null_w * dn * df[5];
    }
  }

  float self_viol = -1.0e6f, min_clear = 1.0e6f;
  if (!pose_only) {
    ik_centres(rb, st, o);
    part += ik_sphere_terms(rb, w, st, o, 0, 1, false, want_grad, -1, metrics, self_viol,
                            min_clear);
  }
  const float cost = cpose + ik_warp_sum(part);

  if (want_grad) {
    if (lane < D) st[o.oGQ + lane] = gd;
    __syncwarp();
    ik_wrenches_tools(rb, st, o, terr, pos_w, rot_w, !pose_only);
    ik_fk_reverse(rb, st, o, st + o.oGQ);
    g = (lane < D) ? st[o.oGQ + lane] : 0.0f;
  }
  if (metrics) {
    met->pe2 = pe2_max; met->re2 = re2_max;
    met->self_viol = ik_warp_max(self_viol);
    met->min_clear = ik_warp_min(min_clear);
  }
  return cost;
}

__device__ __forceinline__ float ik_clip(const IKRobot& rb, float x) {
  const int lane = ik_lane();
  if (lane >= rb.D) return 0.0f;
  return fminf(fmaxf(x, rb.dof_f[6 * lane + 2]), rb.dof_f[6 * lane + 3]);
}

// ---------------------------------------------------------------------------
// L-BFGS with two-loop recursion over a ring of `m` history slots (logical slot
// m-1 is the newest) and a best-of-n backtracking line search, on one warp:
// lane d keeps the d-th entry of every vector in a register and the history
// lies in the warp's shared memory `hist`: S (m D), Y (m D), rho (m), valid
// (m), alpha (m). `mode` is 0 for the full objective or IK_POSE_ONLY for the
// warm-up stage. x is replaced by the best iterate after a gradient
// evaluation.
// ---------------------------------------------------------------------------
__host__ __device__ inline int ik_hist_words(int m, int D) { return 2 * m * D + 3 * m; }

__device__ __forceinline__ float ik_lbfgs(const IKRobot& rb, const IKWorld& w, float* st,
                                       float* hist, float* goal, float& x, int mode,
                                       int n_iters, int m, float max_step, int n_ls,
                                       float ls_base, float ls_log_ratio) {
  const int D = rb.D, lane = ik_lane();
  const bool act = lane < D;
  float* Sh = hist;
  float* Yh = hist + m * D;
  float* rho = hist + 2 * m * D;
  float* valid = rho + m;
  float* alph = valid + m;
  x = ik_clip(rb, x);
  float g;
  float c = ik_eval(rb, w, st, goal, x, g, mode | IK_WANT_GRAD, nullptr);
  for (int i = lane; i < m; i += 32) { valid[i] = 0.0f; rho[i] = 0.0f; }
  __syncwarp();
  int head = 0;  // physical index of logical slot 0 (the oldest)
  float bc = c, bx = x;

  for (int it = 0; it < n_iters; ++it) {
    // ---- two-loop recursion ---------------------------------------------------------
    float r = g;
    for (int i = m - 1; i >= 0; --i) {
      const int ph = (head + i) % m;
      float a = 0.0f;
      if (valid[ph] > 0.0f) {
        a = rho[ph] * ik_warp_sum(act ? Sh[ph * D + lane] * r : 0.0f);
        if (act) r -= a * Yh[ph * D + lane];
      }
      if (lane == 0) alph[i] = a;
    }
    {
      const int ph = (head + m - 1) % m;
      float gamma = 1.0f;
      if (valid[ph] > 0.0f) {
        const float yv = act ? Yh[ph * D + lane] : 0.0f;
        const float sy = ik_warp_sum(act ? Sh[ph * D + lane] * yv : 0.0f);
        const float yy = ik_warp_sum(yv * yv);
        gamma = sy / fmaxf(yy, 1e-10f);
      }
      r *= gamma;
    }
    __syncwarp();
    for (int i = 0; i < m; ++i) {
      const int ph = (head + i) % m;
      if (valid[ph] > 0.0f) {
        const float yr = ik_warp_sum(act ? Yh[ph * D + lane] * r : 0.0f);
        const float coef = alph[i] - rho[ph] * yr;
        if (act) r += Sh[ph * D + lane] * coef;
      }
    }
    // ---- descent safeguard, max-norm step clamp ----------------------------------------
    float dvec = act ? -r : 0.0f;
    const float dg = ik_warp_sum(dvec * g);
    if (!(dg < 0.0f)) dvec = act ? -g : 0.0f;
    const float dn = ik_warp_max(fabsf(dvec));
    dvec *= fminf(1.0f, max_step / fmaxf(dn, 1e-9f));
    // ---- line search: best of n_ls candidates, zero step if none is better ---------------
    float best_a = 0.0f, best_lc = c;
    for (int k = 0; k < n_ls; ++k) {
      const float alpha = ls_base * expf((float)k * ls_log_ratio);
      float gdummy;
      const float ca = ik_eval(rb, w, st, goal, ik_clip(rb, x + alpha * dvec), gdummy, mode, nullptr);
      if (ca < best_lc) { best_a = alpha; best_lc = ca; }
    }
    const float xn = ik_clip(rb, x + best_a * dvec);
    float gn;
    const float cn = ik_eval(rb, w, st, goal, xn, gn, mode | IK_WANT_GRAD, nullptr);
    // ---- history: overwrite the oldest slot, which becomes the newest -------------------
    const float sy = ik_warp_sum(act ? (xn - x) * (gn - g) : 0.0f);
    const bool ok = sy > 1e-10f;
    if (act) {
      Sh[head * D + lane] = ok ? (xn - x) : 0.0f;
      Yh[head * D + lane] = ok ? (gn - g) : 0.0f;
    }
    if (lane == 0) {
      rho[head] = ok ? 1.0f / fmaxf(sy, 1e-10f) : 0.0f;
      valid[head] = ok ? 1.0f : 0.0f;
    }
    __syncwarp();
    head = (head + 1) % m;
    if (cn < bc) { bc = cn; bx = xn; }
    c = cn; x = xn; g = gn;
  }
  x = bx;
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

// The standard normal of dimension d of draw (n, it, pi).
__device__ __forceinline__ float ik_normal(unsigned int k0, unsigned int k1, int n, int it, int pi,
                                           int d) {
  unsigned int o[4];
  ik_philox(k0, k1, (unsigned int)n, (unsigned int)it, (unsigned int)pi, (unsigned int)(d >> 1), o);
  return (d & 1) ? ik_box_muller(o[2], o[3]) : ik_box_muller(o[0], o[1]);
}

// ---------------------------------------------------------------------------
// MPPI on one warp (lane d, dof d): streaming softmax over particles with a
// running-minimum shift; particle 0 of every iteration is the mean itself;
// after the loop the mean is evaluated once more and wins only if strictly
// better. `noise`, when not null, holds pre-drawn standard normals (iters,
// particles, N, D) used instead of Philox.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float ik_mppi(const IKRobot& rb, const IKWorld& w, float* st,
                                      float* goal, float& x, const IKSolveCfg& cfg,
                                      const float* noise, int n, int N) {
  const int D = rb.D, lane = ik_lane();
  const bool act = lane < D;
  float gdummy;
  float mean = ik_clip(rb, x);
  float bc = ik_eval(rb, w, st, goal, mean, gdummy, 0, nullptr);
  float bx = mean;
  float std_ = cfg.init_std;
  const float T = cfg.temperature;
  for (int it = 0; it < cfg.mppi_iters; ++it) {
    float m = 1.0e30f, den = 0.0f, num = 0.0f;
    for (int pi = 0; pi < cfg.n_particles; ++pi) {
      float xp = mean;
      if (pi != 0) {
        float eps = 0.0f;
        if (act) {
          eps = (noise != nullptr)
                    ? noise[(((size_t)it * cfg.n_particles + pi) * N + n) * D + lane]
                    : ik_normal(cfg.seed_lo, cfg.seed_hi, n, it, pi, lane);
        }
        xp = ik_clip(rb, mean + std_ * eps);
      }
      const float cp = ik_eval(rb, w, st, goal, xp, gdummy, 0, nullptr);
      const float m_new = fminf(m, cp);
      const float scale = expf((m_new - m) / T);
      const float wgt = expf((m_new - cp) / T);
      num = num * scale + wgt * xp;
      den = den * scale + wgt;
      if (cp < bc) { bc = cp; bx = xp; }
      m = m_new;
    }
    const float dsafe = fmaxf(den, 1e-12f);
    mean = ik_clip(rb, mean + cfg.step_size * (num / dsafe - mean));
    std_ = fmaxf(std_ * cfg.std_decay, cfg.min_std);
  }
  const float cm = ik_eval(rb, w, st, goal, mean, gdummy, 0, nullptr);
  if (cm < bc) { bc = cm; bx = mean; }
  x = bx;
  return bc;
}
