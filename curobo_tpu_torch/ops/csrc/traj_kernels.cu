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
// Mapping: one block of TRAJ_WARPS = 16 warps per trajectory; warp w
// evaluates steps w, w + 16, ... with the warp-cooperative evaluation of
// ik_device.cuh. The block copies the robot and world tables into shared
// memory once. Every step's state (link frames, sphere centres,
// cotangents) lives in shared memory as well, so step h's swept samples read
// step h-1's centres there after one block barrier, and the cotangent on them
// goes back through shared memory too (step 0 sweeps from itself): each step
// runs one FK forward and one reverse pass. Where a horizon's step state does
// not fit in shared memory (H above about 40 for the Franka) the launch keeps
// it in a global scratch buffer instead, and a world that does not fit either
// goes there compacted (traj_place); nothing else changes. A step's cost
// and metrics are warp sums, written once per step; the trajectory's sums run
// over the steps in order, so every thread of the block holds the same value
// and branches alike. The knot gradient dctrl[c] = sum_h B[h,c] g_h is a
// second pass over a per-step cotangent buffer; only the free-knot rows are
// written.
//
// Registers: the evaluation, the two optimizer loops, the noise draw and the
// finish are separate (not inlined) functions, each allocated on its own, and
// the block's descriptors (tables, buffers, optimizer state, outputs) live in
// static shared memory; that keeps traj_solve within the 128 registers a
// thread of a 16-warp block has, without spills (`-Xptxas -v`). On an NVIDIA
// H100 80GB HBM3 at 700 W, 8 warps took 37.68 ms at the planner's shape
// against 23.86 ms for 16; a 32-warp block (one warp per step at H = 32)
// caps a thread at 64 registers, where these functions spill; it measured
// 11 % faster all the same and is not built (PERF.md section 6).
//
// The optimizer state (x, g, direction, best x, the L-BFGS ring of (s, y)
// pairs, MPPI mean and numerator) is one copy per trajectory in shared memory.
// Its vector work (70 knot variables at the planner's spline) runs on warp 0
// with warp-shuffle dot products and is published to the other warps by the
// barrier that opens the next evaluation. The only matrix products are the
// spline basis (4 H x n_ctrl) x (n_ctrl x D) and the knot gradient, far too
// small for tensor cores, and they run in fp32 (no TF32 anywhere).
//
// Bound on this card: operations, not bytes (a few hundred bytes per
// trajectory in and out against ~1e7..1e9 float operations per solve). The
// motion planner launches 4 or 8 trajectories, so a launch fills 4 or 8 SMs.
//
// Every entry launches on the given stream, does not synchronise, allocates
// nothing, and returns the CUDA error of the launch (0 on success).
#include "ik_device.cuh"

#define TRAJ_N_PIN 3       // control points pinned at each end (transition/bspline.py)
#define TRAJ_MAX_H 128     // most horizon steps
#define TRAJ_WARPS 16       // warps per trajectory's block: 128 registers a thread

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

// State of one step: the evaluation state of ik_layout, then the cotangent on
// the previous step's centres Gp (3 S) and the step's velocity, acceleration
// and jerk (IK_MAXD each; q is the evaluation's).
struct TrajLayout {
  IKLayout e;
  int oGp, oV, oA, oJ, words;
};

__host__ __device__ inline TrajLayout traj_layout(int L, int S) {
  TrajLayout t;
  t.e = ik_layout(L, S);
  t.oGp = t.e.words; t.oV = t.oGp + 3 * S; t.oA = t.oV + IK_MAXD; t.oJ = t.oA + IK_MAXD;
  t.words = t.oJ + IK_MAXD;
  return t;
}

// Per-step scalars (H, 8): cost, terminal pe2 / re2, infeasible, and the
// velocity, acceleration and jerk ratios of the retiming.
#define TS_COST 0
#define TS_PE2 1
#define TS_RE2 2
#define TS_BAD 3
#define TS_RV 4
#define TS_RA 5
#define TS_RJ 6

// Shared memory of one block besides the tables and the per-step state.
struct TrajShared {
  const float* dof_t;  // 9 D
  float* ctrl;         // n_ctrl * D control points
  float* gbuf;         // H * 4 * D per-step cotangents on q, v, a, j (scaled by 1/T^k)
  float* hs;           // H * 8 per-step scalars
  float* goal;         // 8
  float* qs;           // IK_MAXD
  float* qe;           // IK_MAXD
  float* steps;        // H * step words, in shared or in global memory
  int step_words;
  float dt;            // the trajectory's step duration
  const float* x;      // the evaluation's free knots (n_free * D, shared)
  float* grad;         // where it writes their gradient (or null)
};

// Shared words of a block beside the tables and the step state.
__host__ __device__ inline int traj_own_words(const IKRobot& rb, const TrajCfg& tc, int opt_words) {
  return 9 * rb.D + tc.n_ctrl * rb.D + tc.H * 4 * rb.D + 8 * tc.H + 8 + 2 * IK_MAXD + opt_words;
}

__host__ __device__ inline int traj_solve_opt_words(int n, int m) { return (12 + 2 * m) * n + 3 * m; }

// Lays out the block's shared memory after the tables at `p` (copying the dof
// table) and fills the block's descriptor `sh` (in static shared memory, from
// thread 0); returns the first word after it, where the caller's optimizer
// buffers start.
__device__ __forceinline__ float* traj_setup(float* p, int D, int L, int S, const TrajCfg& tc,
                                             TrajShared& sh) {
  const float* dof_t = (const float*)ik_copy_words(p, tc.dof_t, 9 * D);
  float* ctrl = p; p += tc.n_ctrl * D;
  float* gbuf = p; p += tc.H * 4 * D;
  float* hs = p; p += 8 * tc.H;
  float* goal = p; p += 8;
  float* qs = p; p += IK_MAXD;
  float* qe = p; p += IK_MAXD;
  if (threadIdx.x == 0) {
    sh.dof_t = dof_t; sh.ctrl = ctrl; sh.gbuf = gbuf; sh.hs = hs;
    sh.goal = goal; sh.qs = qs; sh.qe = qe;
    sh.step_words = traj_layout(L, S).words;
  }
  return p;
}

__device__ __forceinline__ float traj_clip1(const TrajShared& sh, int D, int i, float v) {
  const float* df = sh.dof_t + 9 * (i % D);
  return fminf(fmaxf(v, df[4]), df[5]);
}

// ---------------------------------------------------------------------------
// The trajectory objective of one block's trajectory at the free knots sh.x
// (shared, n_free * D) with step duration sh.dt: cost (returned to every
// thread); with TRAJ_GRAD the gradient with respect to x into sh.grad (shared,
// n_free * D); with TRAJ_METRICS the terminal errors, feasibility and retimed
// dt into *met. Every thread of the block must call it (it synchronises the
// block). Its inputs travel in shared memory rather than in registers, which
// keeps the step passes under the register cap.
// ---------------------------------------------------------------------------
__device__ __noinline__ float traj_eval(const IKRobot& rb, const IKWorld& w, const TrajCfg& tc,
                                           const TrajShared& sh, int flags, TrajMetrics* met) {
  const bool want_grad = (flags & TRAJ_GRAD) != 0;
  const bool metrics = (flags & TRAJ_METRICS) != 0;
  const int lane = ik_lane(), warp = threadIdx.x >> 5, W = blockDim.x >> 5;
  const int H = tc.H, D = rb.D, nc = tc.n_ctrl, nfD = tc.n_free * D;
  const TrajLayout tl = traj_layout(rb.L, rb.S);
  const IKLayout& o = tl.e;
  const float pos_w = rb.cfg_f[0], rot_w = rb.cfg_f[1];

  // ---- control points: pinned start, free knots, pinned goal ---------------------
  __syncthreads();  // x is complete; the previous evaluation is done with ctrl and gbuf
  const float* x = sh.x;
  for (int i = threadIdx.x; i < nc * D; i += blockDim.x) {
    const int c = i / D, d = i - c * D;
    float v;
    if (c < TRAJ_N_PIN) v = sh.qs[d];
    else if (c < TRAJ_N_PIN + tc.n_free) v = x[(c - TRAJ_N_PIN) * D + d];
    else v = sh.qe[d];
    sh.ctrl[i] = v;
  }
  __syncthreads();

  const float T = sh.dt * (float)(H - 1);
  const float invT = 1.0f / fmaxf(T, 1e-6f);

  // ---- pass 1: spline state of each step (lane d, dof d), FK, sphere centres -------
  for (int h = warp; h < H; h += W) {
    float* st = sh.steps + (size_t)h * sh.step_words;
    if (lane < D) {
      const int d = lane;
      const float* B0 = tc.basis + h * nc;
      const float* B1 = tc.basis + (H + h) * nc;
      const float* B2 = tc.basis + (2 * H + h) * nc;
      const float* B3 = tc.basis + (3 * H + h) * nc;
      float a0 = B0[0] * sh.ctrl[d], a1 = B1[0] * sh.ctrl[d];
      float a2 = B2[0] * sh.ctrl[d], a3 = B3[0] * sh.ctrl[d];
      for (int c = 1; c < nc; ++c) {
        const float cv = sh.ctrl[c * D + d];
        a0 += B0[c] * cv; a1 += B1[c] * cv; a2 += B2[c] * cv; a3 += B3[c] * cv;
      }
      st[o.oQ + d] = a0;
      st[tl.oV + d] = a1 * invT;
      st[tl.oA + d] = a2 * invT * invT;
      st[tl.oJ + d] = a3 * invT * invT * invT;
    }
    __syncwarp();
    ik_fk_forward(rb, st, o);
    ik_centres(rb, st, o);
  }
  __syncthreads();  // every step's centres are written

  // ---- pass 2: per-step terms --------------------------------------------------------
  for (int h = warp; h < H; h += W) {
    float* st = sh.steps + (size_t)h * sh.step_words;
    const bool is_term = h == H - 1;
    float* hs = sh.hs + 8 * h;
    float cpose = 0.0f;
    {
      float pe2 = 0.0f, re2 = 0.0f;
      if (is_term || tc.run_w != 0.0f) {
        const float wpose = is_term ? 1.0f : tc.run_w;
        const IKPoseErr pe = ik_pose_error(sh.goal, st + o.oR + 9 * rb.tool[0], st + o.oP + 3 * rb.tool[0]);
        pe2 = pe.pe2;
        re2 = pe.re2;
        cpose = (pos_w * pe2 + rot_w * re2) * wpose;
      }
      if (metrics && lane == 0) { hs[TS_PE2] = pe2; hs[TS_RE2] = re2; }
    }
    // joint limits (margin-shrunk), vel/acc/jerk hinges, smoothness: lane d, dof d
    float part = 0.0f, oob = 0.0f, rv = 0.0f, ra = 0.0f, rj = 0.0f;
    if (lane < D) {
      const int d = lane;
      const float* df = sh.dof_t + 9 * d;
      const float q = st[o.oQ + d], v = st[tl.oV + d], a = st[tl.oA + d], j = st[tl.oJ + d];
      float lo_v = fmaxf(df[0] - q, 0.0f), hi_v = fmaxf(q - df[1], 0.0f);
      float viol = lo_v + hi_v;
      part = tc.bound_w * viol * viol;
      float gq = 2.0f * tc.bound_w * viol * ((hi_v > 0.0f ? 1.0f : 0.0f) - (lo_v > 0.0f ? 1.0f : 0.0f));
      float gv = 0.0f, ga = 0.0f, gj = 0.0f;
      if (tc.vel_bw > 0.0f) {
        float e = fmaxf(fabsf(v) - df[6], 0.0f);
        part += tc.vel_bw * e * e;
        gv += 2.0f * tc.vel_bw * e * ik_sign(v);
      }
      if (tc.acc_bw > 0.0f) {
        float e = fmaxf(fabsf(a) - df[7], 0.0f);
        part += tc.acc_bw * e * e;
        ga += 2.0f * tc.acc_bw * e * ik_sign(a);
      }
      if (tc.jerk_bw > 0.0f) {
        float e = fmaxf(fabsf(j) - df[8], 0.0f);
        part += tc.jerk_bw * e * e;
        gj += 2.0f * tc.jerk_bw * e * ik_sign(j);
      }
      if (tc.smooth_v > 0.0f) { part += tc.smooth_v * v * v; gv += 2.0f * tc.smooth_v * v; }
      if (tc.smooth_a > 0.0f) { part += tc.smooth_a * a * a; ga += 2.0f * tc.smooth_a * a; }
      if (tc.smooth_j > 0.0f) { part += tc.smooth_j * j * j; gj += 2.0f * tc.smooth_j * j; }
      if (want_grad) {
        float* gb = sh.gbuf + h * 4 * D;
        gb[d] = gq;
        gb[D + d] = gv * invT;
        gb[2 * D + d] = ga * invT * invT;
        gb[3 * D + d] = gj * invT * invT * invT;
      }
      if (metrics) {
        if (q < df[2] - 1e-4f || q > df[3] + 1e-4f) oob = 1.0f;
        rv = fabsf(v) / df[6];
        ra = fabsf(a) / df[7];
        rj = fabsf(j) / df[8];
      }
    }
    bool any_oob = false;
    if (metrics) {
      any_oob = __any_sync(IK_FULL, oob > 0.5f);
      rv = ik_warp_max(rv); ra = ik_warp_max(ra); rj = ik_warp_max(rj);
      if (lane == 0) { hs[TS_RV] = rv; hs[TS_RA] = ra; hs[TS_RJ] = rj; }
    }
    // self collision at this step, swept scene term from step h-1's centres
    float self_viol = -1.0e6f, min_clear = 1.0e6f;
    part += ik_sphere_terms(rb, w, st, o, h > 0 ? -sh.step_words : 0, tc.K, tc.speed_metric != 0,
                            want_grad, tl.oGp, metrics, self_viol, min_clear);
    hs = sh.hs + 8 * h;
    const float cst = cpose + ik_warp_sum(part);
    if (metrics) {
      const float sv = ik_warp_max(self_viol), mc = ik_warp_min(min_clear);
      if (lane == 0) hs[TS_BAD] = (mc < 0.0f || sv > 0.0f || any_oob) ? 1.0f : 0.0f;
    }
    if (lane == 0) hs[TS_COST] = cst;
  }

  // ---- gradient: the step h+1 sweep's cotangent on these centres, wrenches, ------
  // ---- reverse FK, then dctrl[c] = sum_h B0 g_q + B1 g_v / T + B2 g_a / T^2 + B3 g_j / T^3
  if (want_grad) {
    __syncthreads();  // every step's cotangents on its predecessor are written
    for (int h = warp; h < H; h += W) {
      float* st = sh.steps + (size_t)h * sh.step_words;
      const float* nxt = sh.steps + (size_t)(h + 1) * sh.step_words;
      for (int i = lane; i < 3 * rb.S; i += 32) {
        float add = 0.0f;
        if (h == 0) add += st[tl.oGp + i];  // step 0 sweeps from itself
        if (h + 1 < H) add += nxt[tl.oGp + i];
        st[o.oG + i] += add;
      }
      __syncwarp();
      const bool is_term = h == H - 1;
      const bool pose_on = is_term || tc.run_w != 0.0f;
      const float wpose = is_term ? 1.0f : tc.run_w;
      IKPoseErr pe = {};
      if (pose_on) pe = ik_pose_error(sh.goal, st + o.oR + 9 * rb.tool[0], st + o.oP + 3 * rb.tool[0]);
      ik_wrenches(rb, st, o, pose_on, pos_w * wpose, rot_w * wpose, pe, true);
      ik_fk_reverse(rb, st, o, sh.gbuf + h * 4 * D);
    }
    __syncthreads();
    for (int r = threadIdx.x; r < nfD; r += blockDim.x) {
      const int c = TRAJ_N_PIN + r / D, d = r % D;
      float s = 0.0f;
      for (int hh = 0; hh < H; ++hh) {
        const float* gb = sh.gbuf + hh * 4 * D;
        s += tc.basis[hh * nc + c] * gb[d] + tc.basis[(H + hh) * nc + c] * gb[D + d] +
             tc.basis[(2 * H + hh) * nc + c] * gb[2 * D + d] +
             tc.basis[(3 * H + hh) * nc + c] * gb[3 * D + d];
      }
      sh.grad[r] = s;
    }
  }
  __syncthreads();  // every step's scalars (and the gradient) are written

  float total = 0.0f;
  for (int h = 0; h < H; ++h) total += sh.hs[8 * h + TS_COST];
  if (metrics) {
    met->pe2 = sh.hs[8 * (H - 1) + TS_PE2];
    met->re2 = sh.hs[8 * (H - 1) + TS_RE2];
    float bad = 0.0f, rv = 0.0f, ra = 0.0f, rj = 0.0f;
    for (int h = 0; h < H; ++h) {
      const float* hs = sh.hs + 8 * h;
      bad += hs[TS_BAD];
      rv = fmaxf(rv, hs[TS_RV]); ra = fmaxf(ra, hs[TS_RA]); rj = fmaxf(rj, hs[TS_RJ]);
    }
    met->feasible = bad < 0.5f ? 1.0f : 0.0f;
    met->dt_ret = sh.dt * fmaxf(rv, fmaxf(sqrtf(ra), cbrtf(rj))) * 1.01f;
  }
  return total;
}

// traj_eval at x, writing the gradient to grad: thread 0 records the request
// and the evaluation's opening barrier publishes it (every thread calls this
// with the same arguments).
__device__ __forceinline__ float traj_eval_at(const IKRobot& rb, const IKWorld& w,
                                              const TrajCfg& tc, TrajShared& sh, const float* x,
                                              float* grad, int flags, TrajMetrics* met) {
  if (threadIdx.x == 0) { sh.x = x; sh.grad = grad; }
  return traj_eval(rb, w, tc, sh, flags, met);
}

// Loads one trajectory's goal, start and (pinned) end configuration and its
// clamped step duration into shared memory.
__device__ __forceinline__ void traj_load(TrajShared& sh, int D, int n, const float* goal7,
                                          const float* q_start, const float* q_end,
                                          const float* dt) {
  for (int i = threadIdx.x; i < 7; i += blockDim.x) sh.goal[i] = goal7[(size_t)n * 7 + i];
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    sh.qs[i] = q_start[(size_t)n * D + i];
    sh.qe[i] = q_end[(size_t)n * D + i];
  }
  if (threadIdx.x == 0) sh.dt = fmaxf(dt[n], 1e-4f);
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

// Tables, the block's shared layout and the step state (shared, or this
// block's part of `steps_global`); returns the first word of the optimizer
// buffers. The descriptors rb, w and sh are in static shared memory. Ends
// with a barrier.
__device__ __forceinline__ float* traj_block_setup(const IKRobot& rbg, const IKWorld& wg,
                                                   const float* wglob, const TrajCfg& tc,
                                                   float* smem, float* steps_global,
                                                   int opt_words, IKRobot& rb, IKWorld& w,
                                                   TrajShared& sh) {
  float* p = ik_load_tables(rbg, wg, wglob, smem, rb, w);
  float* opt = traj_setup(p, rbg.D, rbg.L, rbg.S, tc, sh);
  if (threadIdx.x == 0)
    sh.steps = steps_global != nullptr
                   ? steps_global + (size_t)blockIdx.x * tc.H * traj_layout(rbg.L, rbg.S).words
                   : opt + opt_words;
  __syncthreads();  // the dof table and the descriptors are in place
  return opt;
}

// mode: 0 cost, TRAJ_GRAD cost + gradient, TRAJ_METRICS cost + metrics.
__global__ void __launch_bounds__(32 * TRAJ_WARPS, 1)
traj_cost_grad_kernel(IKRobot rbg, IKWorld wg, const float* wglob, TrajCfg tc,
                      const float* __restrict__ goal7,
                      const float* __restrict__ x, const float* __restrict__ q_start,
                      const float* __restrict__ q_end, const float* __restrict__ dt,
                      float* __restrict__ cost, float* __restrict__ grad,
                      float* __restrict__ pos_err, float* __restrict__ rot_err,
                      float* __restrict__ feas, float* __restrict__ dt_ret, float* steps_global,
                      int mode) {
  extern __shared__ float smem[];
  __shared__ IKRobot rb;
  __shared__ IKWorld w;
  __shared__ TrajShared sh;
  const int n = blockIdx.x, D = rbg.D, nfD = tc.n_free * D;
  float* xs = traj_block_setup(rbg, wg, wglob, tc, smem, steps_global, 2 * nfD, rb, w, sh);
  float* gs = xs + nfD;
  traj_load(sh, D, n, goal7, q_start, q_end, dt);
  for (int i = threadIdx.x; i < nfD; i += blockDim.x) xs[i] = x[(size_t)n * nfD + i];
  TrajMetrics met;
  const float c = traj_eval_at(rb, w, tc, sh, xs, gs, mode, &met);
  if (mode & TRAJ_METRICS) {
    traj_write_metrics(n, c, met, cost, pos_err, rot_err, feas, dt_ret);
  } else if (threadIdx.x == 0) {
    cost[n] = c;
  }
  if (mode & TRAJ_GRAD)
    for (int i = threadIdx.x; i < nfD; i += blockDim.x) grad[(size_t)n * nfD + i] = gs[i];
}

// ---------------------------------------------------------------------------
// Optimizer loops over the block's knot vector, state in shared memory; the
// vector work runs on warp 0 (lane l owning entries l, l + 32, ...), the
// evaluations on the whole block.
// ---------------------------------------------------------------------------
struct TrajOptState {
  float *x, *g, *dv, *xn, *gn, *bx, *r, *S, *Y;  // L-BFGS (S, Y: history * n each)
  float *rho, *valid, *alph;                    // history
  float *mean, *num, *xp, *eps, *eps2;          // MPPI
};

__device__ __forceinline__ float traj_warp_dot(const float* a, const float* b, int n) {
  float s = 0.0f;
  for (int i = ik_lane(); i < n; i += 32) s += a[i] * b[i];
  return ik_warp_sum(s);
}

// Same semantics as the IK kernel's ik_lbfgs: two-loop recursion over a ring of
// m slots (logical slot m-1 the newest), descent safeguard, max-norm step
// clamp, best of n_ls candidates ls_base * ls_ratio^k (zero step when none is
// better), curvature guard on the new pair, best iterate after each gradient
// evaluation. x (shared) is replaced by the best iterate. The budget is read
// from `cfg`, the kernel's parameter, where it costs no registers.
__device__ __noinline__ float traj_lbfgs(const IKRobot& rb, const IKWorld& w, const TrajCfg& tc,
                            TrajShared& sh, const TrajOptState& o, const TrajSolveCfg& cfg) {
  const int n = tc.n_free * rb.D, D = rb.D, lane = ik_lane(), m = cfg.history;
  const bool w0 = threadIdx.x < 32;
  if (w0) {
    for (int i = lane; i < n; i += 32) o.x[i] = traj_clip1(sh, D, i, o.x[i]);
    for (int i = lane; i < m; i += 32) { o.rho[i] = 0.0f; o.valid[i] = 0.0f; }
  }
  float c = traj_eval_at(rb, w, tc, sh, o.x, o.g, TRAJ_GRAD, nullptr);
  int head = 0;  // physical index of logical slot 0 (the oldest)
  float bc = c;
  if (w0)
    for (int i = lane; i < n; i += 32) o.bx[i] = o.x[i];

  for (int it = 0; it < cfg.lbfgs_iters; ++it) {
    if (w0) {
      // ---- two-loop recursion -------------------------------------------------------
      for (int i = lane; i < n; i += 32) o.r[i] = o.g[i];
      for (int i = m - 1; i >= 0; --i) {
        const int ph = (head + i) % m;
        float al = 0.0f;
        if (o.valid[ph] > 0.0f) {
          al = o.rho[ph] * traj_warp_dot(o.S + ph * n, o.r, n);
          for (int k = lane; k < n; k += 32) o.r[k] -= al * o.Y[ph * n + k];
        }
        if (lane == 0) o.alph[i] = al;
      }
      {
        const int ph = (head + m - 1) % m;
        float gamma = 1.0f;
        if (o.valid[ph] > 0.0f) {
          const float sy = traj_warp_dot(o.S + ph * n, o.Y + ph * n, n);
          const float yy = traj_warp_dot(o.Y + ph * n, o.Y + ph * n, n);
          gamma = sy / fmaxf(yy, 1e-10f);
        }
        for (int k = lane; k < n; k += 32) o.r[k] *= gamma;
      }
      __syncwarp();
      for (int i = 0; i < m; ++i) {
        const int ph = (head + i) % m;
        if (o.valid[ph] > 0.0f) {
          const float yr = traj_warp_dot(o.Y + ph * n, o.r, n);
          const float coef = o.alph[i] - o.rho[ph] * yr;
          for (int k = lane; k < n; k += 32) o.r[k] += o.S[ph * n + k] * coef;
        }
      }
      // ---- descent safeguard, max-norm step clamp --------------------------------------
      float part = 0.0f;
      for (int k = lane; k < n; k += 32) { o.dv[k] = -o.r[k]; part += o.dv[k] * o.g[k]; }
      const float dg = ik_warp_sum(part);
      float dmax = 0.0f;
      for (int k = lane; k < n; k += 32) {
        if (!(dg < 0.0f)) o.dv[k] = -o.g[k];
        dmax = fmaxf(dmax, fabsf(o.dv[k]));
      }
      const float dn = ik_warp_max(dmax);
      const float sclamp = fminf(1.0f, cfg.max_step / fmaxf(dn, 1e-9f));
      for (int k = lane; k < n; k += 32) o.dv[k] *= sclamp;
    }
    // ---- line search: best of n_ls candidates, zero step if none is better ---------------
    float best_a = 0.0f, best_lc = c;
    for (int k = 0; k < cfg.n_linesearch; ++k) {
      const float alpha = cfg.ls_base * expf((float)k * logf(cfg.ls_ratio));
      if (w0)
        for (int i = lane; i < n; i += 32) o.xn[i] = traj_clip1(sh, D, i, o.x[i] + alpha * o.dv[i]);
      const float ca = traj_eval_at(rb, w, tc, sh, o.xn, nullptr, 0, nullptr);
      if (ca < best_lc) { best_a = alpha; best_lc = ca; }
    }
    if (w0)
      for (int i = lane; i < n; i += 32) o.xn[i] = traj_clip1(sh, D, i, o.x[i] + best_a * o.dv[i]);
    const float cn = traj_eval_at(rb, w, tc, sh, o.xn, o.gn, TRAJ_GRAD, nullptr);
    // ---- history: overwrite the oldest slot, which becomes the newest -------------------
    const bool better = cn < bc;
    if (w0) {
      float part = 0.0f;
      for (int k = lane; k < n; k += 32) part += (o.xn[k] - o.x[k]) * (o.gn[k] - o.g[k]);
      const float sy = ik_warp_sum(part);
      const bool ok = sy > 1e-10f;
      for (int k = lane; k < n; k += 32) {
        o.S[head * n + k] = ok ? (o.xn[k] - o.x[k]) : 0.0f;
        o.Y[head * n + k] = ok ? (o.gn[k] - o.g[k]) : 0.0f;
        if (better) o.bx[k] = o.xn[k];
        o.x[k] = o.xn[k];
        o.g[k] = o.gn[k];
      }
      if (lane == 0) {
        o.rho[head] = ok ? 1.0f / fmaxf(sy, 1e-10f) : 0.0f;
        o.valid[head] = ok ? 1.0f : 0.0f;
      }
      __syncwarp();
    }
    head = (head + 1) % m;
    if (better) bc = cn;
    c = cn;
  }
  if (w0)
    for (int k = lane; k < n; k += 32) o.x[k] = o.bx[k];
  return bc;
}

// The trajectory's MPPI noise for (iteration, particle), on warp 0: standard
// normals over the n knot variables, Philox 4x32-10 keyed by the seed with
// counter (trajectory, iteration, particle, j) giving variables 2j and 2j+1
// (the counter layout of the IK kernel's noise), or read from injected noise
// (iters, particles, N, n); then the optional smoothing eps'[k D + d] =
// sum_j L[k, j] eps[j D + d] (weights under 1e-8 skipped). Lane l reads back
// only entries l, l + 32, ... of the result.
__device__ __noinline__ const float* traj_noise(const TrajSolveCfg& cfg, const TrajOptState& o,
                                                   const float* noise, const float* eps_smooth,
                                                   int traj, int N, int it, int pi, int n_free,
                                                   int D) {
  const int n = n_free * D, lane = ik_lane();
  if (noise != nullptr) {
    const float* src = noise + (((size_t)it * cfg.n_particles + pi) * N + traj) * n;
    for (int i = lane; i < n; i += 32) o.eps[i] = src[i];
  } else {
    for (int jj = lane; 2 * jj < n; jj += 32) {
      unsigned int bits[4];
      ik_philox(cfg.seed_lo, cfg.seed_hi, (unsigned int)traj, (unsigned int)it,
                (unsigned int)pi, (unsigned int)jj, bits);
      o.eps[2 * jj] = ik_box_muller(bits[0], bits[1]);
      if (2 * jj + 1 < n) o.eps[2 * jj + 1] = ik_box_muller(bits[2], bits[3]);
    }
  }
  __syncwarp();
  if (eps_smooth == nullptr) return o.eps;
  for (int r = lane; r < n; r += 32) {
    const int k = r / D, d = r % D;
    float acc = 0.0f;
    for (int jk = 0; jk < n_free; ++jk) {
      const float wgt = eps_smooth[k * n_free + jk];
      if (fabsf(wgt) < 1e-8f) continue;
      acc += wgt * o.eps[jk * D + d];
    }
    o.eps2[r] = acc;
  }
  return o.eps2;
}

// Same semantics as the IK kernel's ik_mppi: streaming softmax over particles
// with a running-minimum shift; particle 0 of every iteration is the mean
// itself; after the loop the mean is evaluated once more and wins only if
// strictly better. x (shared) is replaced by the best point.
__device__ __noinline__ float traj_mppi(const IKRobot& rb, const IKWorld& w, const TrajCfg& tc,
                           TrajShared& sh, const TrajOptState& o, const TrajSolveCfg& cfg,
                           const float* noise, const float* eps_smooth, int traj, int N) {
  const int n = tc.n_free * rb.D, D = rb.D, lane = ik_lane();
  const bool w0 = threadIdx.x < 32;
  if (w0)
    for (int i = lane; i < n; i += 32) o.mean[i] = traj_clip1(sh, D, i, o.x[i]);
  float bc = traj_eval_at(rb, w, tc, sh, o.mean, nullptr, 0, nullptr);
  if (w0)
    for (int i = lane; i < n; i += 32) o.bx[i] = o.mean[i];
  float std_ = cfg.init_std;
  const float T = cfg.temperature;
  for (int it = 0; it < cfg.mppi_iters; ++it) {
    float m = 1.0e30f, den = 0.0f;
    if (w0)
      for (int i = lane; i < n; i += 32) o.num[i] = 0.0f;
    for (int pi = 0; pi < cfg.n_particles; ++pi) {
      if (w0) {
        if (pi == 0) {
          for (int i = lane; i < n; i += 32) o.xp[i] = o.mean[i];
        } else {
          const float* eps = traj_noise(cfg, o, noise, eps_smooth, traj, N, it, pi, tc.n_free, D);
          for (int i = lane; i < n; i += 32) o.xp[i] = traj_clip1(sh, D, i, o.mean[i] + std_ * eps[i]);
        }
      }
      const float cp = traj_eval_at(rb, w, tc, sh, o.xp, nullptr, 0, nullptr);
      const float m_new = fminf(m, cp);
      const float scale = expf((m_new - m) / T);
      const float wgt = expf((m_new - cp) / T);
      const bool better = cp < bc;
      if (w0)
        for (int i = lane; i < n; i += 32) {
          o.num[i] = o.num[i] * scale + wgt * o.xp[i];
          if (better) o.bx[i] = o.xp[i];
        }
      den = den * scale + wgt;
      if (better) bc = cp;
      m = m_new;
    }
    const float dsafe = fmaxf(den, 1e-12f);
    if (w0)
      for (int i = lane; i < n; i += 32)
        o.mean[i] = traj_clip1(sh, D, i, o.mean[i] + cfg.step_size * (o.num[i] / dsafe - o.mean[i]));
    std_ = fmaxf(std_ * cfg.std_decay, cfg.min_std);
  }
  const float cm = traj_eval_at(rb, w, tc, sh, o.mean, nullptr, 0, nullptr);
  const bool use_mean = cm < bc;
  if (use_mean) bc = cm;
  if (w0)
    for (int i = lane; i < n; i += 32) o.x[i] = use_mean ? o.mean[i] : o.bx[i];
  return bc;
}

// traj_solve's outputs, recorded in static shared memory at the start.
struct TrajOut {
  float *x_out, *cost, *pos_err, *rot_err, *feas, *dt_ret;
};

// The metrics of the solution o.x and the outputs of this block's trajectory.
// A call of its own, like the optimizer loops, reading the output pointers
// from shared memory, so that the kernel body keeps nothing live across the
// calls (its registers are capped at 64 in a 32-warp block).
__device__ __noinline__ void traj_finish(const IKRobot& rb, const IKWorld& w, const TrajCfg& tc,
                                         TrajShared& sh, const TrajOptState& o,
                                         const TrajOut& out) {
  const int traj = blockIdx.x, n = tc.n_free * rb.D;
  TrajMetrics met;
  const float c = traj_eval_at(rb, w, tc, sh, o.x, nullptr, TRAJ_METRICS, &met);
  traj_write_metrics(traj, c, met, out.cost, out.pos_err, out.rot_err, out.feas, out.dt_ret);
  for (int i = threadIdx.x; i < n; i += blockDim.x) out.x_out[(size_t)traj * n + i] = o.x[i];
}

__global__ void __launch_bounds__(32 * TRAJ_WARPS, 1)
traj_solve_kernel(IKRobot rbg, IKWorld wg, const float* wglob, TrajCfg tc, TrajSolveCfg cfg,
                  const float* __restrict__ goal7, const float* __restrict__ x0,
                  const float* __restrict__ q_start, const float* __restrict__ q_end,
                  const float* __restrict__ dt, const float* __restrict__ noise,
                  const float* __restrict__ eps_smooth, float* __restrict__ x_out,
                  float* __restrict__ cost, float* __restrict__ pos_err,
                  float* __restrict__ rot_err, float* __restrict__ feas,
                  float* __restrict__ dt_ret, float* steps_global, int N) {
  extern __shared__ float smem[];
  __shared__ IKRobot rb;
  __shared__ IKWorld w;
  __shared__ TrajShared sh;
  __shared__ TrajOptState o;
  __shared__ TrajOut out;
  const int traj = blockIdx.x, D = rbg.D, n = tc.n_free * D, m = cfg.history;
  float* base = traj_block_setup(rbg, wg, wglob, tc, smem, steps_global,
                                 traj_solve_opt_words(n, m), rb, w, sh);
  if (threadIdx.x == 0) {
    o.x = base; o.g = o.x + n; o.dv = o.g + n; o.xn = o.dv + n; o.gn = o.xn + n;
    o.bx = o.gn + n; o.r = o.bx + n; o.mean = o.r + n; o.num = o.mean + n; o.xp = o.num + n;
    o.eps = o.xp + n; o.eps2 = o.eps + n; o.S = o.eps2 + n; o.Y = o.S + m * n;
    o.rho = o.Y + m * n; o.valid = o.rho + m; o.alph = o.valid + m;
    out.x_out = x_out; out.cost = cost; out.pos_err = pos_err; out.rot_err = rot_err;
    out.feas = feas; out.dt_ret = dt_ret;
  }
  traj_load(sh, D, traj, goal7, q_start, q_end, dt);
  for (int i = threadIdx.x; i < n; i += blockDim.x) base[i] = x0[(size_t)traj * n + i];  // o.x
  __syncthreads();

  if (cfg.mppi_iters > 0) traj_mppi(rb, w, tc, sh, o, cfg, noise, eps_smooth, blockIdx.x, N);
  traj_lbfgs(rb, w, tc, sh, o, cfg);
  traj_finish(rb, w, tc, sh, o, out);
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

// ---------------------------------------------------------------------------
// Launch geometry
// ---------------------------------------------------------------------------
// Where a launch keeps a trajectory's step state and the world rows. Both stay
// in shared memory when they fit beside the robot tables and the block's own
// state; otherwise the step state goes to global memory first (the world rows
// are read in the innermost loop), then, if the rest still does not fit, the
// world too. The global buffer holds the compacted world (when it goes there)
// and then N blocks of step state.
struct TrajPlace {
  bool steps_shared, world_shared;
  size_t smem, world_words, step_words;  // shared bytes, global words per part
};

static TrajPlace traj_place(const IKRobot* rb, const IKWorld* w, const TrajCfg* tc,
                            int opt_words) {
  const size_t lim = ik_smem_limit_words();
  const size_t robot = ik_robot_words(*rb), world = ik_world_words(*w);
  const size_t own = traj_own_words(*rb, *tc, opt_words);
  const size_t steps = (size_t)tc->H * traj_layout(rb->L, rb->S).words;
  TrajPlace t;
  t.steps_shared = robot + world + own + steps <= lim;
  t.world_shared = robot + world + own + (t.steps_shared ? steps : 0) <= lim;
  if (!t.world_shared) t.steps_shared = robot + own + steps <= lim;
  t.world_words = t.world_shared ? 0 : ik_world_global_words(*w);
  t.step_words = t.steps_shared ? 0 : steps;
  t.smem = sizeof(float) * (robot + (t.world_shared ? world : 0) + own +
                            (t.steps_shared ? steps : 0));
  return t;
}

static long long traj_scratch_words_for(const TrajPlace& t, int N) {
  return (long long)t.world_words + (long long)N * (long long)t.step_words;
}

// Sets the kernel's shared memory, compacts a world that goes to global memory
// into the head of `scratch` and points `wglob` and `steps` into it; returns
// the CUDA error (0 when the launch can go ahead).
template <class K>
static int traj_prepare(K kernel, const TrajPlace& t, const TrajCfg* tc, const IKWorld* w,
                        float* scratch, cudaStream_t stream, const float** wglob, float** steps) {
  *wglob = nullptr;
  *steps = nullptr;
  if (tc->H < 2 || tc->H > TRAJ_MAX_H) return (int)cudaErrorInvalidConfiguration;
  if ((t.world_words > 0 || t.step_words > 0) && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)t.smem);
  if (err != 0) return err;
  if (t.step_words > 0) *steps = scratch + t.world_words;
  *wglob = ik_stage_world(*w, t.world_shared, scratch, stream, &err);
  return err;
}

extern "C" {

int traj_max_horizon() { return TRAJ_MAX_H; }

// Words of the global buffer a launch of N trajectories needs (0 when its step
// state and world fit in shared memory).
long long traj_cost_grad_scratch_words(const IKRobot* rb, const IKWorld* w, const TrajCfg* tc,
                                       int N) {
  return traj_scratch_words_for(traj_place(rb, w, tc, 2 * tc->n_free * rb->D), N);
}

long long traj_solve_scratch_words(const IKRobot* rb, const IKWorld* w, const TrajCfg* tc,
                                   int history, int N) {
  return traj_scratch_words_for(
      traj_place(rb, w, tc, traj_solve_opt_words(tc->n_free * rb->D, history)), N);
}

int traj_cost_grad_launch(const IKRobot* rb, const IKWorld* w, const TrajCfg* tc,
                          const float* goal7, const float* x, const float* q_start,
                          const float* q_end, const float* dt, float* cost, float* grad,
                          float* pos_err, float* rot_err, float* feas, float* dt_ret,
                          float* scratch, int N, int mode, void* stream) {
  if (N <= 0) return 0;
  const TrajPlace t = traj_place(rb, w, tc, 2 * tc->n_free * rb->D);
  const float* wglob;
  float* steps;
  int err = traj_prepare(traj_cost_grad_kernel, t, tc, w, scratch, (cudaStream_t)stream, &wglob,
                         &steps);
  if (err != 0) return err;
  traj_cost_grad_kernel<<<N, 32 * TRAJ_WARPS, t.smem, (cudaStream_t)stream>>>(
      *rb, *w, wglob, *tc, goal7, x, q_start, q_end, dt, cost, grad, pos_err, rot_err, feas,
      dt_ret, steps, mode);
  return (int)cudaGetLastError();
}

int traj_solve_launch(const IKRobot* rb, const IKWorld* w, const TrajCfg* tc,
                      const TrajSolveCfg* cfg, const float* goal7, const float* x0,
                      const float* q_start, const float* q_end, const float* dt,
                      const float* noise, const float* eps_smooth, float* x_out, float* cost,
                      float* pos_err, float* rot_err, float* feas, float* dt_ret, float* scratch,
                      int N, void* stream) {
  if (N <= 0) return 0;
  const TrajPlace t = traj_place(rb, w, tc, traj_solve_opt_words(tc->n_free * rb->D, cfg->history));
  const float* wglob;
  float* steps;
  int err = traj_prepare(traj_solve_kernel, t, tc, w, scratch, (cudaStream_t)stream, &wglob,
                         &steps);
  if (err != 0) return err;
  traj_solve_kernel<<<N, 32 * TRAJ_WARPS, t.smem, (cudaStream_t)stream>>>(
      *rb, *w, wglob, *tc, *cfg, goal7, x0, q_start, q_end, dt, noise, eps_smooth, x_out, cost,
      pos_err, rot_err, feas, dt_ret, steps, N);
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
