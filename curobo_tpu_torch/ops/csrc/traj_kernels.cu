// The two trajectory kernels and their plain C entry points (loaded with ctypes).
//
// traj_cost_grad: replaces PallasTrajCost._build -> kernel (the lane-horizon
//   `_lane_eval`, curobo_tpu/ops/pallas_traj.py): the trajectory objective of
//   B-spline knots and, by mode, its gradient with respect to the free knots,
//   or the metrics (terminal pose errors, feasibility, retimed dt).
// traj_solve: replaces PallasTrajCost.build_solver: optional MPPI over the
//   knots (optional STOMP smoothing of the noise) -> L-BFGS over the knots with
//   the knot-wise clip -> metrics and retimed dt, a whole seed-solve per
//   trajectory in one launch.
//
// Mapping: one block per trajectory, one thread per horizon step (blockDim is
// H rounded up to a warp, at most 128). Thread h evaluates step h: spline
// state from the control points in shared memory, FK, pose, bound and
// smoothness terms, the self-collision hinge, and the swept scene term between
// the sphere centres of step h-1 (read from thread h-1's scratch; step 0 sweeps
// from itself) and its own. The cotangent on step h-1's centres goes back to
// thread h-1, so each step runs one FK forward and one reverse pass. Per
// trajectory sums (cost, terminal errors, feasibility, the retiming maxima)
// are block reductions (warp shuffles, then shared memory across warps); the
// knot gradient dctrl[c] = sum_h B[h,c] g_h is a second pass over a per-step
// cotangent buffer in shared memory, and only the free-knot rows are written.
// The optimizer state (x, g, direction, best x, the L-BFGS ring of (s, y)
// pairs, MPPI mean and numerator) is one copy per trajectory in shared memory;
// its dot products are block reductions, so every thread of a block holds the
// same scalars and takes the same branches.
//
// Bound on this card: operations, not bytes (a few hundred bytes per
// trajectory in and out against ~1e7..1e9 float operations per solve). The
// motion planner launches 4 or 8 trajectories, so a launch fills 4 or 8 SMs
// with one warp each and the serial chain of one step's evaluation (FK, 694
// pairs, 61 spheres x K sweep samples x obstacles) sets the time.
//
// Every entry launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().
#include "ik_device.cuh"

#define TRAJ_N_PIN 3       // control points pinned at each end (transition/bspline.py)
#define TRAJ_MAX_H 128     // most horizon steps (one thread each)
#define TRAJ_MAX_HIST 32   // most L-BFGS history slots

#define TRAJ_GRAD 1
#define TRAJ_METRICS 4

struct TrajCfg {
  const float* basis;  // (4, H, n_ctrl): B0, B1, B2, B3 (value, 1st..3rd derivative)
  const float* dof_t;  // (D, 9): cost lo, cost hi (margin-shrunk), lim lo, lim hi,
                       //         clip lo, clip hi, velocity, acceleration, jerk limits
  float bound_w, vel_bw, acc_bw, jerk_bw;  // joint-limit and vel/acc/jerk hinge weights
  float smooth_v, smooth_a, smooth_j;      // squared vel/acc/jerk weights, already / H
  float run_w;                             // pose weight of a non-terminal step
  int H, n_ctrl, n_free, K, speed_metric;
};

struct TrajSolveCfg {
  int mppi_iters, n_particles;
  float init_std, std_decay, min_std, temperature, step_size;
  int lbfgs_iters, history;
  float max_step;
  int n_linesearch;
  float ls_base, ls_ratio;
  unsigned int seed_lo, seed_hi;
};

struct TrajMetrics {
  float pe2, re2, feasible, dt_ret;
};

// Per-thread scratch in global memory, [block][slot][thread], the block's
// width as the lane stride: a warp's access to one slot is one 128-byte line.
struct TrajScratch {
  float* base;
  int stride;
  __device__ __forceinline__ float& at(int slot) const { return base[(size_t)slot * stride]; }
};

__host__ __device__ inline int traj_scratch_slots(int L, int S) { return 18 * L + 9 * S; }

// Shared memory of one block, in floats.
struct TrajShared {
  float* ctrl;   // n_ctrl * D control points
  float* gbuf;   // blockDim * 4 * D per-step cotangents on q, v, a, j (scaled by 1/T^k)
  float* red;    // 32 warp partials
  float* goal;   // 7
  float* qs;     // D
  float* qe;     // D
};

__host__ __device__ inline int traj_shared_eval_floats(int n_ctrl, int D, int block) {
  return n_ctrl * D + block * 4 * D + 32 + 7 + 2 * D;
}

__device__ __forceinline__ TrajShared traj_shared(float* smem, int n_ctrl, int D) {
  TrajShared sh;
  sh.ctrl = smem;
  sh.gbuf = sh.ctrl + n_ctrl * D;
  sh.red = sh.gbuf + blockDim.x * 4 * D;
  sh.goal = sh.red + 32;
  sh.qs = sh.goal + 7;
  sh.qe = sh.qs + D;
  return sh;
}

// ---------------------------------------------------------------------------
// Block reductions. Every thread returns the same value, summed in the same
// order, so block-uniform control flow can branch on it.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float traj_block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) t += red[i];
  return t;
}

__device__ __forceinline__ float traj_block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) t = fmaxf(t, red[i]);
  return t;
}

// dot product of two block vectors of length n (thread t owns indices t + k blockDim)
__device__ __forceinline__ float traj_dot(const float* a, const float* b, int n, float* red) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += a[i] * b[i];
  return traj_block_sum(s, red);
}

__device__ __forceinline__ void traj_clip(const TrajCfg& tc, int D, float* x, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* df = tc.dof_t + 9 * (i % D);
    x[i] = fminf(fmaxf(x[i], df[4]), df[5]);
  }
}

// ---------------------------------------------------------------------------
// The trajectory objective of one block's trajectory at free knots x (shared,
// n_free * D): cost (returned to every thread); with TRAJ_GRAD the gradient
// with respect to x into grad (shared, n_free * D); with TRAJ_METRICS the
// terminal errors, feasibility and retimed dt into *met. Every thread of the
// block must call it (it synchronises the block).
// ---------------------------------------------------------------------------
__device__ __noinline__ float traj_eval(const IKRobot& rb, const IKWorld& w, const TrajCfg& tc,
                                        const TrajScratch& sc, const TrajShared& sh, float dt,
                                        const float* x, float* grad, int flags, TrajMetrics* met) {
  const bool want_grad = (flags & TRAJ_GRAD) != 0;
  const bool metrics = (flags & TRAJ_METRICS) != 0;
  const int h = threadIdx.x, H = tc.H, D = rb.D, L = rb.L, S = rb.S, nc = tc.n_ctrl;
  const int nfD = tc.n_free * D;
  const bool live = h < H;
  const int oR = 0, oP = 9 * L, oF = 12 * L, oT = 15 * L, oC = 18 * L;
  const int oG = 18 * L + 3 * S, oGp = 18 * L + 6 * S;
  const float pos_w = rb.cfg_f[0], rot_w = rb.cfg_f[1], sc_w = rb.cfg_f[4], sc_act = rb.cfg_f[5];
  const float coll_w = rb.cfg_f[6], coll_act = rb.cfg_f[7];

  // ---- control points: pinned start, free knots, pinned goal ---------------------
  __syncthreads();  // x is complete; the previous evaluation is done with ctrl and gbuf
  for (int i = h; i < nc * D; i += blockDim.x) {
    const int c = i / D, d = i - c * D;
    float v;
    if (c < TRAJ_N_PIN) v = sh.qs[d];
    else if (c < TRAJ_N_PIN + tc.n_free) v = x[(c - TRAJ_N_PIN) * D + d];
    else v = sh.qe[d];
    sh.ctrl[i] = v;
  }
  __syncthreads();

  const float T = dt * (float)(H - 1);
  const float invT = 1.0f / fmaxf(T, 1e-6f);
  float q[IK_MAXD], v[IK_MAXD], a[IK_MAXD], j[IK_MAXD];
  float gq[IK_MAXD], gv[IK_MAXD], ga[IK_MAXD], gj[IK_MAXD];

  // ---- spline state of step h, FK, sphere centres ------------------------------
  if (live) {
    const float* B0 = tc.basis + h * nc;
    const float* B1 = tc.basis + (H + h) * nc;
    const float* B2 = tc.basis + (2 * H + h) * nc;
    const float* B3 = tc.basis + (3 * H + h) * nc;
    for (int d = 0; d < D; ++d) {
      float a0 = B0[0] * sh.ctrl[d], a1 = B1[0] * sh.ctrl[d];
      float a2 = B2[0] * sh.ctrl[d], a3 = B3[0] * sh.ctrl[d];
      for (int c = 1; c < nc; ++c) {
        const float cv = sh.ctrl[c * D + d];
        a0 += B0[c] * cv; a1 += B1[c] * cv; a2 += B2[c] * cv; a3 += B3[c] * cv;
      }
      q[d] = a0;
      v[d] = a1 * invT;
      a[d] = a2 * invT * invT;
      j[d] = a3 * invT * invT * invT;
    }
    ik_fk_forward(rb, sc, q, oR, oP);
    for (int si = 0; si < S; ++si) {
      const float* sf = rb.sph_f + 4 * si;
      const int li = rb.sph_link[si];
      for (int e = 0; e < 3; ++e) {
        sc.at(oC + 3 * si + e) = sc.at(oR + 9 * li + 3 * e) * sf[0] +
                                 sc.at(oR + 9 * li + 3 * e + 1) * sf[1] +
                                 sc.at(oR + 9 * li + 3 * e + 2) * sf[2] + sc.at(oP + 3 * li + e);
        if (want_grad) { sc.at(oG + 3 * si + e) = 0.0f; sc.at(oGp + 3 * si + e) = 0.0f; }
      }
    }
    if (want_grad)
      for (int e = 0; e < 3 * L; ++e) { sc.at(oF + e) = 0.0f; sc.at(oT + e) = 0.0f; }
  }
  __syncthreads();  // every step's centres are written

  float cost = 0.0f, pe2 = 0.0f, re2 = 0.0f;
  float self_viol = -1.0e6f, min_clear = 1.0e6f, oob = 0.0f, rv = 0.0f, ra = 0.0f, rj = 0.0f;
  if (live) {
    const int hprev = h > 0 ? h - 1 : 0;
    const TrajScratch prev{sc.base - (h - hprev), sc.stride};
    const bool is_term = h == H - 1;

    // ---- pose (terminal step, and the run weight elsewhere) ----------------------
    const float wpose = is_term ? 1.0f : tc.run_w;
    if (is_term || tc.run_w != 0.0f) {
      const int ti = rb.tool;
      float Rt[9], tp[3];
      for (int e = 0; e < 9; ++e) Rt[e] = sc.at(oR + 9 * ti + e);
      for (int e = 0; e < 3; ++e) tp[e] = sc.at(oP + 3 * ti + e);
      const IKPoseErr pe = ik_pose_error(sh.goal, Rt, tp);
      pe2 = pe.pe2;
      re2 = pe.re2;
      cost += (pos_w * pe2 + rot_w * re2) * wpose;
      if (want_grad) ik_tool_wrench(sc, ti, oF, oT, pos_w * wpose, rot_w * wpose, pe, Rt, tp);
    }

    // ---- joint limits (margin-shrunk), vel/acc/jerk hinges, smoothness ----------------
    for (int d = 0; d < D; ++d) {
      const float* df = tc.dof_t + 9 * d;
      float lo_v = fmaxf(df[0] - q[d], 0.0f), hi_v = fmaxf(q[d] - df[1], 0.0f);
      float viol = lo_v + hi_v;
      cost += tc.bound_w * viol * viol;
      gq[d] = 2.0f * tc.bound_w * viol * ((hi_v > 0.0f ? 1.0f : 0.0f) - (lo_v > 0.0f ? 1.0f : 0.0f));
      gv[d] = ga[d] = gj[d] = 0.0f;
      if (tc.vel_bw > 0.0f) {
        float e = fmaxf(fabsf(v[d]) - df[6], 0.0f);
        cost += tc.vel_bw * e * e;
        gv[d] += 2.0f * tc.vel_bw * e * ik_sign(v[d]);
      }
      if (tc.acc_bw > 0.0f) {
        float e = fmaxf(fabsf(a[d]) - df[7], 0.0f);
        cost += tc.acc_bw * e * e;
        ga[d] += 2.0f * tc.acc_bw * e * ik_sign(a[d]);
      }
      if (tc.jerk_bw > 0.0f) {
        float e = fmaxf(fabsf(j[d]) - df[8], 0.0f);
        cost += tc.jerk_bw * e * e;
        gj[d] += 2.0f * tc.jerk_bw * e * ik_sign(j[d]);
      }
      if (tc.smooth_v > 0.0f) { cost += tc.smooth_v * v[d] * v[d]; gv[d] += 2.0f * tc.smooth_v * v[d]; }
      if (tc.smooth_a > 0.0f) { cost += tc.smooth_a * a[d] * a[d]; ga[d] += 2.0f * tc.smooth_a * a[d]; }
      if (tc.smooth_j > 0.0f) { cost += tc.smooth_j * j[d] * j[d]; gj[d] += 2.0f * tc.smooth_j * j[d]; }
      if (metrics) {
        if (q[d] < df[2] - 1e-4f || q[d] > df[3] + 1e-4f) oob = 1.0f;
        rv = fmaxf(rv, fabsf(v[d]) / df[6]);
        ra = fmaxf(ra, fabsf(a[d]) / df[7]);
        rj = fmaxf(rj, fabsf(j[d]) / df[8]);
      }
    }

    // ---- self collision: hinge over live pairs at this step -------------------------
    float sc_sum = 0.0f;
    for (int k = 0; k < rb.P; ++k) {
      const int pa = rb.pair_i[2 * k], pb = rb.pair_i[2 * k + 1];
      const float m = rb.pair_m[k];
      float ddx = sc.at(oC + 3 * pa) - sc.at(oC + 3 * pb);
      float ddy = sc.at(oC + 3 * pa + 1) - sc.at(oC + 3 * pb + 1);
      float ddz = sc.at(oC + 3 * pa + 2) - sc.at(oC + 3 * pb + 2);
      float dist = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz + 1e-12f);
      float hv = m + sc_act - dist;
      if (hv > 0.0f) {
        sc_sum += hv;
        if (want_grad) {
          float cf = -sc_w / dist;
          sc.at(oG + 3 * pa) += cf * ddx; sc.at(oG + 3 * pa + 1) += cf * ddy; sc.at(oG + 3 * pa + 2) += cf * ddz;
          sc.at(oG + 3 * pb) -= cf * ddx; sc.at(oG + 3 * pb + 1) -= cf * ddy; sc.at(oG + 3 * pb + 2) -= cf * ddz;
        }
      }
      if (metrics) self_viol = fmaxf(self_viol, m - dist);
    }
    cost += sc_w * sc_sum;

    // ---- swept scene term: K samples from step h-1's centres to step h's ---------------
    const int K = tc.K;
    const float ct_base = -coll_w / (float)K;
    float scene = 0.0f;
    for (int si = 0; si < S; ++si) {
      const float rad = rb.sph_f[4 * si + 3];
      if (rad < 0.0f) continue;
      const float sx = sc.at(oC + 3 * si), sy = sc.at(oC + 3 * si + 1), sz = sc.at(oC + 3 * si + 2);
      const float px = prev.at(oC + 3 * si), py = prev.at(oC + 3 * si + 1), pz = prev.at(oC + 3 * si + 2);
      float spd = 1.0f, nrm = 1.0f;
      if (tc.speed_metric) {
        float ex = sx - px, ey = sy - py, ez = sz - pz;
        nrm = sqrtf(ex * ex + ey * ey + ez * ez + 1e-12f);
        spd = nrm + 1e-3f;
      }
      float pen = 0.0f;
      float cs[3] = {0.0f, 0.0f, 0.0f}, cp[3] = {0.0f, 0.0f, 0.0f};
      for (int k = 1; k <= K; ++k) {
        const float alpha = (float)((double)k / (double)K);
        const float om = (float)(1.0 - (double)k / (double)K);
        float g3[3];
        float msdf = ik_scene_msdf(w, px * om + sx * alpha, py * om + sy * alpha,
                                   pz * om + sz * alpha, want_grad, g3);
        float viol = coll_act + rad - msdf;
        pen += fmaxf(0.0f, viol);
        if (want_grad && viol > 0.0f) {
          const float ct = ct_base * spd;
          for (int e = 0; e < 3; ++e) { cs[e] += alpha * ct * g3[e]; cp[e] += om * ct * g3[e]; }
        }
        if (metrics && k == K) min_clear = fminf(min_clear, msdf - rad);
      }
      pen = pen / (float)K;
      scene += pen * spd;
      if (want_grad) {
        if (tc.speed_metric) {
          const float cspd = coll_w * pen / nrm;
          cs[0] += cspd * (sx - px); cs[1] += cspd * (sy - py); cs[2] += cspd * (sz - pz);
          cp[0] -= cspd * (sx - px); cp[1] -= cspd * (sy - py); cp[2] -= cspd * (sz - pz);
        }
        for (int e = 0; e < 3; ++e) {
          sc.at(oG + 3 * si + e) += cs[e];
          sc.at(oGp + 3 * si + e) += cp[e];
        }
      }
    }
    cost += coll_w * scene;
  }

  // ---- gradient: the step h+1 sweep's cotangent on these centres, reverse FK, ------
  // ---- then dctrl[c] = sum_h B0 g_q + B1 g_v / T + B2 g_a / T^2 + B3 g_j / T^3 -------
  if (want_grad) {
    __syncthreads();  // every step's cotangents on its predecessor are written
    if (live) {
      for (int si = 0; si < S; ++si)
        for (int e = 0; e < 3; ++e) {
          float add = 0.0f;
          if (h == 0) add += sc.at(oGp + 3 * si + e);  // step 0 sweeps from itself
          if (h + 1 < H) add += sc.base[(size_t)(oGp + 3 * si + e) * sc.stride + 1];
          sc.at(oG + 3 * si + e) += add;
        }
      ik_sphere_wrench(rb, sc, oC, oG, oF, oT);
      ik_fk_reverse(rb, sc, gq, oR, oP, oF, oT);
      float* gb = sh.gbuf + h * 4 * D;
      for (int d = 0; d < D; ++d) {
        gb[d] = gq[d];
        gb[D + d] = gv[d] * invT;
        gb[2 * D + d] = ga[d] * invT * invT;
        gb[3 * D + d] = gj[d] * invT * invT * invT;
      }
    }
    __syncthreads();
    for (int r = h; r < nfD; r += blockDim.x) {
      const int c = TRAJ_N_PIN + r / D, d = r % D;
      float s = 0.0f;
      for (int hh = 0; hh < H; ++hh) {
        const float* gb = sh.gbuf + hh * 4 * D;
        s += tc.basis[hh * nc + c] * gb[d] + tc.basis[(H + hh) * nc + c] * gb[D + d] +
             tc.basis[(2 * H + hh) * nc + c] * gb[2 * D + d] +
             tc.basis[(3 * H + hh) * nc + c] * gb[3 * D + d];
      }
      grad[r] = s;
    }
  }

  const float total = traj_block_sum(cost, sh.red);
  if (metrics) {
    const bool term = live && h == H - 1;
    met->pe2 = traj_block_sum(term ? pe2 : 0.0f, sh.red);
    met->re2 = traj_block_sum(term ? re2 : 0.0f, sh.red);
    const bool bad = live && (min_clear < 0.0f || self_viol > 0.0f || oob > 0.5f);
    met->feasible = traj_block_sum(bad ? 1.0f : 0.0f, sh.red) < 0.5f ? 1.0f : 0.0f;
    rv = traj_block_max(rv, sh.red);
    ra = traj_block_max(ra, sh.red);
    rj = traj_block_max(rj, sh.red);
    met->dt_ret = dt * fmaxf(rv, fmaxf(sqrtf(ra), cbrtf(rj))) * 1.01f;
  }
  return total;
}

// Loads one trajectory's goal, start and (pinned) end configuration into shared
// memory and returns the clamped step duration.
__device__ __forceinline__ float traj_load(const TrajShared& sh, int D, int n,
                                           const float* goal7, const float* q_start,
                                           const float* q_end, const float* dt) {
  for (int i = threadIdx.x; i < 7; i += blockDim.x) sh.goal[i] = goal7[(size_t)n * 7 + i];
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    sh.qs[i] = q_start[(size_t)n * D + i];
    sh.qe[i] = q_end[(size_t)n * D + i];
  }
  return fmaxf(dt[n], 1e-4f);
}

__device__ __forceinline__ void traj_write_metrics(int n, float c, const TrajMetrics& met,
                                                   float* cost, float* pos_err, float* rot_err,
                                                   float* feas, float* dt_ret) {
  if (threadIdx.x == 0) {
    cost[n] = c;
    pos_err[n] = sqrtf(fmaxf(met.pe2, 1e-16f));
    rot_err[n] = sqrtf(fmaxf(met.re2, 1e-16f));
    feas[n] = met.feasible;
    dt_ret[n] = met.dt_ret;
  }
}

// mode: 0 cost, TRAJ_GRAD cost + gradient, TRAJ_METRICS cost + metrics.
__global__ void traj_cost_grad_kernel(IKRobot rb, IKWorld w, TrajCfg tc,
                                      const float* __restrict__ goal7, const float* __restrict__ x,
                                      const float* __restrict__ q_start,
                                      const float* __restrict__ q_end, const float* __restrict__ dt,
                                      float* __restrict__ cost, float* __restrict__ grad,
                                      float* __restrict__ pos_err, float* __restrict__ rot_err,
                                      float* __restrict__ feas, float* __restrict__ dt_ret,
                                      float* scratch, int slots, int mode) {
  extern __shared__ float smem[];
  const int n = blockIdx.x, D = rb.D, nfD = tc.n_free * D;
  TrajShared sh = traj_shared(smem, tc.n_ctrl, D);
  float* xs = sh.qe + D;
  float* gs = xs + nfD;
  const TrajScratch sc{scratch + (size_t)blockIdx.x * slots * blockDim.x + threadIdx.x,
                       (int)blockDim.x};
  const float dtv = traj_load(sh, D, n, goal7, q_start, q_end, dt);
  for (int i = threadIdx.x; i < nfD; i += blockDim.x) xs[i] = x[(size_t)n * nfD + i];
  TrajMetrics met;
  const float c = traj_eval(rb, w, tc, sc, sh, dtv, xs, gs, mode, &met);
  if (mode & TRAJ_METRICS) {
    traj_write_metrics(n, c, met, cost, pos_err, rot_err, feas, dt_ret);
  } else if (threadIdx.x == 0) {
    cost[n] = c;
  }
  if (mode & TRAJ_GRAD)
    for (int i = threadIdx.x; i < nfD; i += blockDim.x) grad[(size_t)n * nfD + i] = gs[i];
}

// ---------------------------------------------------------------------------
// Optimizer loops over the block's knot vector, state in shared memory.
// ---------------------------------------------------------------------------
struct TrajOptState {
  float *x, *g, *dv, *xn, *gn, *bx, *r, *S, *Y;  // L-BFGS (S, Y: history * n each)
  float *mean, *num, *xp, *eps, *eps2;          // MPPI
};

__host__ __device__ inline int traj_shared_opt_floats(int nfD, int history) {
  return (12 + 2 * history) * nfD;
}

// Same semantics as the IK kernel's ik_lbfgs: two-loop recursion over a ring of
// m slots (logical slot m-1 the newest), descent safeguard, max-norm step
// clamp, best of n_ls candidates ls_base * ls_ratio^k (zero step when none is
// better), curvature guard on the new pair, best iterate after each gradient
// evaluation. x (shared) is replaced by the best iterate.
__device__ float traj_lbfgs(const IKRobot& rb, const IKWorld& w, const TrajCfg& tc,
                            const TrajScratch& sc, const TrajShared& sh, const TrajOptState& o,
                            float dt, float* x, int n_iters, int m, float max_step, int n_ls,
                            float ls_base, float ls_log_ratio) {
  const int n = tc.n_free * rb.D, t0 = threadIdx.x, bs = blockDim.x;
  float rho[TRAJ_MAX_HIST], valid[TRAJ_MAX_HIST], alph[TRAJ_MAX_HIST];
  for (int i = 0; i < m; ++i) { rho[i] = 0.0f; valid[i] = 0.0f; }
  traj_clip(tc, rb.D, x, n);
  float c = traj_eval(rb, w, tc, sc, sh, dt, x, o.g, TRAJ_GRAD, nullptr);
  int head = 0;  // physical index of logical slot 0 (the oldest)
  float bc = c;
  for (int i = t0; i < n; i += bs) o.bx[i] = x[i];

  for (int it = 0; it < n_iters; ++it) {
    // ---- two-loop recursion ---------------------------------------------------------
    for (int i = t0; i < n; i += bs) o.r[i] = o.g[i];
    for (int i = m - 1; i >= 0; --i) {
      const int ph = (head + i) % m;
      float al = 0.0f;
      if (valid[ph] > 0.0f) {
        al = rho[ph] * traj_dot(o.S + ph * n, o.r, n, sh.red);
        for (int k = t0; k < n; k += bs) o.r[k] -= al * o.Y[ph * n + k];
      }
      alph[i] = al;
    }
    {
      const int ph = (head + m - 1) % m;
      float gamma = 1.0f;
      if (valid[ph] > 0.0f) {
        const float sy = traj_dot(o.S + ph * n, o.Y + ph * n, n, sh.red);
        const float yy = traj_dot(o.Y + ph * n, o.Y + ph * n, n, sh.red);
        gamma = sy / fmaxf(yy, 1e-10f);
      }
      for (int k = t0; k < n; k += bs) o.r[k] *= gamma;
    }
    for (int i = 0; i < m; ++i) {
      const int ph = (head + i) % m;
      if (valid[ph] > 0.0f) {
        const float yr = traj_dot(o.Y + ph * n, o.r, n, sh.red);
        const float coef = alph[i] - rho[ph] * yr;
        for (int k = t0; k < n; k += bs) o.r[k] += o.S[ph * n + k] * coef;
      }
    }
    // ---- descent safeguard, max-norm step clamp ----------------------------------------
    float part = 0.0f;
    for (int k = t0; k < n; k += bs) { o.dv[k] = -o.r[k]; part += o.dv[k] * o.g[k]; }
    const float dg = traj_block_sum(part, sh.red);
    float dmax = 0.0f;
    for (int k = t0; k < n; k += bs) {
      if (!(dg < 0.0f)) o.dv[k] = -o.g[k];
      dmax = fmaxf(dmax, fabsf(o.dv[k]));
    }
    const float dn = traj_block_max(dmax, sh.red);
    const float sclamp = fminf(1.0f, max_step / fmaxf(dn, 1e-9f));
    for (int k = t0; k < n; k += bs) o.dv[k] *= sclamp;
    // ---- line search: best of n_ls candidates, zero step if none is better ---------------
    float best_a = 0.0f, best_lc = c;
    for (int k = 0; k < n_ls; ++k) {
      const float alpha = ls_base * expf((float)k * ls_log_ratio);
      for (int i = t0; i < n; i += bs) o.xn[i] = x[i] + alpha * o.dv[i];
      traj_clip(tc, rb.D, o.xn, n);
      const float ca = traj_eval(rb, w, tc, sc, sh, dt, o.xn, nullptr, 0, nullptr);
      if (ca < best_lc) { best_a = alpha; best_lc = ca; }
    }
    for (int i = t0; i < n; i += bs) o.xn[i] = x[i] + best_a * o.dv[i];
    traj_clip(tc, rb.D, o.xn, n);
    const float cn = traj_eval(rb, w, tc, sc, sh, dt, o.xn, o.gn, TRAJ_GRAD, nullptr);
    // ---- history: overwrite the oldest slot, which becomes the newest -------------------
    part = 0.0f;
    for (int k = t0; k < n; k += bs) part += (o.xn[k] - x[k]) * (o.gn[k] - o.g[k]);
    const float sy = traj_block_sum(part, sh.red);
    const bool ok = sy > 1e-10f;
    for (int k = t0; k < n; k += bs) {
      o.S[head * n + k] = ok ? (o.xn[k] - x[k]) : 0.0f;
      o.Y[head * n + k] = ok ? (o.gn[k] - o.g[k]) : 0.0f;
    }
    rho[head] = ok ? 1.0f / fmaxf(sy, 1e-10f) : 0.0f;
    valid[head] = ok ? 1.0f : 0.0f;
    head = (head + 1) % m;
    const bool better = cn < bc;
    if (better) bc = cn;
    c = cn;
    for (int k = t0; k < n; k += bs) {
      if (better) o.bx[k] = o.xn[k];
      x[k] = o.xn[k];
      o.g[k] = o.gn[k];
    }
  }
  for (int k = t0; k < n; k += bs) x[k] = o.bx[k];
  return bc;
}

// The trajectory's MPPI noise for (iteration, particle): standard normals over
// the n knot variables, Philox 4x32-10 keyed by the seed with counter
// (trajectory, iteration, particle, j) giving variables 2j and 2j+1 (the
// counter layout of the IK kernel's noise), or read from injected noise
// (iters, particles, N, n); then the optional smoothing eps'[k D + d] =
// sum_j L[k, j] eps[j D + d] (weights under 1e-8 skipped).
__device__ __forceinline__ const float* traj_noise(const TrajSolveCfg& cfg, const TrajOptState& o,
                                                   const float* noise, const float* eps_smooth,
                                                   int traj, int N, int it, int pi, int n_free,
                                                   int D) {
  const int n = n_free * D, t0 = threadIdx.x, bs = blockDim.x;
  __syncthreads();  // the previous particle's readers of eps/eps2 are done
  if (noise != nullptr) {
    const float* src = noise + (((size_t)it * cfg.n_particles + pi) * N + traj) * n;
    for (int i = t0; i < n; i += bs) o.eps[i] = src[i];
  } else {
    for (int jj = t0; 2 * jj < n; jj += bs) {
      unsigned int bits[4];
      ik_philox(cfg.seed_lo, cfg.seed_hi, (unsigned int)traj, (unsigned int)it,
                (unsigned int)pi, (unsigned int)jj, bits);
      o.eps[2 * jj] = ik_box_muller(bits[0], bits[1]);
      if (2 * jj + 1 < n) o.eps[2 * jj + 1] = ik_box_muller(bits[2], bits[3]);
    }
  }
  __syncthreads();
  if (eps_smooth == nullptr) return o.eps;
  for (int r = t0; r < n; r += bs) {
    const int k = r / D, d = r % D;
    float acc = 0.0f;
    for (int jk = 0; jk < n_free; ++jk) {
      const float wgt = eps_smooth[k * n_free + jk];
      if (fabsf(wgt) < 1e-8f) continue;
      acc += wgt * o.eps[jk * D + d];
    }
    o.eps2[r] = acc;
  }
  return o.eps2;  // thread t reads only the entries it wrote
}

// Same semantics as the IK kernel's ik_mppi: streaming softmax over particles
// with a running-minimum shift; particle 0 of every iteration is the mean
// itself; after the loop the mean is evaluated once more and wins only if
// strictly better. x (shared) is replaced by the best point.
__device__ float traj_mppi(const IKRobot& rb, const IKWorld& w, const TrajCfg& tc,
                           const TrajScratch& sc, const TrajShared& sh, const TrajOptState& o,
                           float dt, float* x, const TrajSolveCfg& cfg, const float* noise,
                           const float* eps_smooth, int traj, int N) {
  const int n = tc.n_free * rb.D, t0 = threadIdx.x, bs = blockDim.x;
  for (int i = t0; i < n; i += bs) o.mean[i] = x[i];
  traj_clip(tc, rb.D, o.mean, n);
  float bc = traj_eval(rb, w, tc, sc, sh, dt, o.mean, nullptr, 0, nullptr);
  for (int i = t0; i < n; i += bs) o.bx[i] = o.mean[i];
  float std_ = cfg.init_std;
  const float T = cfg.temperature;
  for (int it = 0; it < cfg.mppi_iters; ++it) {
    float m = 1.0e30f, den = 0.0f;
    for (int i = t0; i < n; i += bs) o.num[i] = 0.0f;
    for (int pi = 0; pi < cfg.n_particles; ++pi) {
      const float* eps = traj_noise(cfg, o, noise, eps_smooth, traj, N, it, pi, tc.n_free, rb.D);
      for (int i = t0; i < n; i += bs) o.xp[i] = (pi == 0) ? o.mean[i] : o.mean[i] + std_ * eps[i];
      if (pi != 0) traj_clip(tc, rb.D, o.xp, n);
      const float cp = traj_eval(rb, w, tc, sc, sh, dt, o.xp, nullptr, 0, nullptr);
      const float m_new = fminf(m, cp);
      const float scale = expf((m_new - m) / T);
      const float wgt = expf((m_new - cp) / T);
      const bool better = cp < bc;
      for (int i = t0; i < n; i += bs) {
        o.num[i] = o.num[i] * scale + wgt * o.xp[i];
        if (better) o.bx[i] = o.xp[i];
      }
      den = den * scale + wgt;
      if (better) bc = cp;
      m = m_new;
    }
    const float dsafe = fmaxf(den, 1e-12f);
    for (int i = t0; i < n; i += bs) o.mean[i] = o.mean[i] + cfg.step_size * (o.num[i] / dsafe - o.mean[i]);
    traj_clip(tc, rb.D, o.mean, n);
    std_ = fmaxf(std_ * cfg.std_decay, cfg.min_std);
  }
  const float cm = traj_eval(rb, w, tc, sc, sh, dt, o.mean, nullptr, 0, nullptr);
  const bool use_mean = cm < bc;
  if (use_mean) bc = cm;
  for (int i = t0; i < n; i += bs) x[i] = use_mean ? o.mean[i] : o.bx[i];
  return bc;
}

__global__ void traj_solve_kernel(IKRobot rb, IKWorld w, TrajCfg tc, TrajSolveCfg cfg,
                                  const float* __restrict__ goal7, const float* __restrict__ x0,
                                  const float* __restrict__ q_start,
                                  const float* __restrict__ q_end, const float* __restrict__ dt,
                                  const float* __restrict__ noise,
                                  const float* __restrict__ eps_smooth, float* __restrict__ x_out,
                                  float* __restrict__ cost, float* __restrict__ pos_err,
                                  float* __restrict__ rot_err, float* __restrict__ feas,
                                  float* __restrict__ dt_ret, float* scratch, int slots, int N) {
  extern __shared__ float smem[];
  const int traj = blockIdx.x, D = rb.D, n = tc.n_free * D;
  TrajShared sh = traj_shared(smem, tc.n_ctrl, D);
  float* base = sh.qe + D;
  TrajOptState o;
  o.x = base; o.g = o.x + n; o.dv = o.g + n; o.xn = o.dv + n; o.gn = o.xn + n;
  o.bx = o.gn + n; o.r = o.bx + n; o.mean = o.r + n; o.num = o.mean + n; o.xp = o.num + n;
  o.eps = o.xp + n; o.eps2 = o.eps + n; o.S = o.eps2 + n; o.Y = o.S + cfg.history * n;
  const TrajScratch sc{scratch + (size_t)blockIdx.x * slots * blockDim.x + threadIdx.x,
                       (int)blockDim.x};
  const float dtv = traj_load(sh, D, traj, goal7, q_start, q_end, dt);
  for (int i = threadIdx.x; i < n; i += blockDim.x) o.x[i] = x0[(size_t)traj * n + i];

  if (cfg.mppi_iters > 0) traj_mppi(rb, w, tc, sc, sh, o, dtv, o.x, cfg, noise, eps_smooth, traj, N);
  traj_lbfgs(rb, w, tc, sc, sh, o, dtv, o.x, cfg.lbfgs_iters, cfg.history, cfg.max_step,
             cfg.n_linesearch, cfg.ls_base, logf(cfg.ls_ratio));

  TrajMetrics met;
  const float c = traj_eval(rb, w, tc, sc, sh, dtv, o.x, nullptr, TRAJ_METRICS, &met);
  traj_write_metrics(traj, c, met, cost, pos_err, rot_err, feas, dt_ret);
  for (int i = threadIdx.x; i < n; i += blockDim.x) x_out[(size_t)traj * n + i] = o.x[i];
}

// The standard normals traj_solve draws for its MPPI stage when it is given no
// noise: out (iters, particles, N, n), one thread per pair of variables.
__global__ void traj_philox_normal_kernel(unsigned int k0, unsigned int k1, int N, int iters,
                                          int particles, int n, float* __restrict__ out) {
  const int J = (n + 1) / 2;
  size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t total = (size_t)iters * particles * N * J;
  if (idx >= total) return;
  int jj = (int)(idx % J);
  size_t row = idx / J;  // (it, pi, traj) row-major
  int traj = (int)(row % N);
  int pi = (int)((row / N) % particles);
  int it = (int)(row / ((size_t)N * particles));
  unsigned int bits[4];
  ik_philox(k0, k1, (unsigned int)traj, (unsigned int)it, (unsigned int)pi, (unsigned int)jj, bits);
  out[row * n + 2 * jj] = ik_box_muller(bits[0], bits[1]);
  if (2 * jj + 1 < n) out[row * n + 2 * jj + 1] = ik_box_muller(bits[2], bits[3]);
}

static int traj_block(int H) { return ((H + 31) / 32) * 32; }

extern "C" {

int traj_max_horizon() { return TRAJ_MAX_H; }

int traj_max_history() { return TRAJ_MAX_HIST; }

int traj_threads(int H) { return traj_block(H); }

int traj_scratch_floats_per_thread(int L, int S) { return traj_scratch_slots(L, S); }

int traj_cost_grad_launch(const IKRobot* rb, const IKWorld* w, const TrajCfg* tc,
                          const float* goal7, const float* x, const float* q_start,
                          const float* q_end, const float* dt, float* cost, float* grad,
                          float* pos_err, float* rot_err, float* feas, float* dt_ret,
                          float* scratch, int N, int mode, void* stream) {
  if (N <= 0) return 0;
  const int block = traj_block(tc->H);
  const int nfD = tc->n_free * rb->D;
  const size_t smem =
      sizeof(float) * (size_t)(traj_shared_eval_floats(tc->n_ctrl, rb->D, block) + 2 * nfD);
  cudaError_t e = cudaFuncSetAttribute(traj_cost_grad_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  traj_cost_grad_kernel<<<N, block, smem, (cudaStream_t)stream>>>(
      *rb, *w, *tc, goal7, x, q_start, q_end, dt, cost, grad, pos_err, rot_err, feas, dt_ret,
      scratch, traj_scratch_slots(rb->L, rb->S), mode);
  return (int)cudaGetLastError();
}

int traj_solve_launch(const IKRobot* rb, const IKWorld* w, const TrajCfg* tc,
                      const TrajSolveCfg* cfg, const float* goal7, const float* x0,
                      const float* q_start, const float* q_end, const float* dt,
                      const float* noise, const float* eps_smooth, float* x_out, float* cost,
                      float* pos_err, float* rot_err, float* feas, float* dt_ret, float* scratch,
                      int N, void* stream) {
  if (N <= 0) return 0;
  const int block = traj_block(tc->H);
  const int nfD = tc->n_free * rb->D;
  const size_t smem = sizeof(float) * (size_t)(traj_shared_eval_floats(tc->n_ctrl, rb->D, block) +
                                               traj_shared_opt_floats(nfD, cfg->history));
  cudaError_t e = cudaFuncSetAttribute(traj_solve_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  traj_solve_kernel<<<N, block, smem, (cudaStream_t)stream>>>(
      *rb, *w, *tc, *cfg, goal7, x0, q_start, q_end, dt, noise, eps_smooth, x_out, cost, pos_err,
      rot_err, feas, dt_ret, scratch, traj_scratch_slots(rb->L, rb->S), N);
  return (int)cudaGetLastError();
}

int traj_philox_normal_launch(unsigned int seed_lo, unsigned int seed_hi, int N, int iters,
                              int particles, int n, float* out, void* stream) {
  long long total = (long long)iters * particles * N * ((n + 1) / 2);
  if (total <= 0) return 0;
  int blocks = (int)((total + 127) / 128);
  traj_philox_normal_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(seed_lo, seed_hi, N, iters,
                                                                      particles, n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
