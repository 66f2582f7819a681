// The two IK kernels and their plain C entry points (loaded with ctypes).
//
// ik_cost_grad: replaces PallasIKCost._build -> kernel_grad / kernel_fwd
//   (curobo_tpu/ops/pallas_ik.py): cost (N,) and, when asked, grad (N, D).
// ik_solve: replaces PallasIKCost.build_solver / build_mppi_solver /
//   build_lbfgs_solver: a whole solve per configuration in one launch, pose-only
//   L-BFGS warm-up -> optional MPPI -> full-cost L-BFGS -> metrics. With the
//   other stages' budgets at 0 it is the MPPI-only or the L-BFGS-only solver.
//
// Bound on this card: operations, not bytes (a few hundred bytes in and out per
// configuration against ~1e4..1e7 float operations). One thread per
// configuration and 32-thread blocks, so that a batch of a few thousand
// configurations spreads over as many SMs as it has warps; the card is mostly
// idle at that size, and the serial chain of one configuration sets the time.
//
// Every entry launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().
#include "ik_device.cuh"

__global__ void ik_cost_grad_kernel(IKRobot rb, IKWorld w, const float* __restrict__ goal7,
                                    const float* __restrict__ q, float* __restrict__ cost,
                                    float* __restrict__ grad, float* scratch, int slots,
                                    int N, int want_grad) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  IKScratch sc = ik_scratch(scratch, slots, n);
  float goal[7], x[IK_MAXD], g[IK_MAXD];
  for (int a = 0; a < 7; ++a) goal[a] = goal7[(size_t)n * 7 + a];
  for (int d = 0; d < rb.D; ++d) x[d] = q[(size_t)n * rb.D + d];
  float c = ik_eval(rb, w, sc, goal, x, g, want_grad ? IK_WANT_GRAD : 0, nullptr);
  cost[n] = c;
  if (want_grad)
    for (int d = 0; d < rb.D; ++d) grad[(size_t)n * rb.D + d] = g[d];
}

__global__ void ik_solve_kernel(IKRobot rb, IKWorld w, IKSolveCfg cfg,
                                const float* __restrict__ goal7, const float* __restrict__ x0,
                                const float* __restrict__ noise, float* __restrict__ x_out,
                                float* __restrict__ cost, float* __restrict__ pos_err,
                                float* __restrict__ rot_err, float* __restrict__ feas,
                                float* scratch, int slots, int N) {
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  IKScratch sc = ik_scratch(scratch, slots, n);
  const int oH = ik_eval_slots(rb.L, rb.S);
  const float ls_log_ratio = logf(cfg.ls_ratio);
  float goal[7], x[IK_MAXD];
  for (int a = 0; a < 7; ++a) goal[a] = goal7[(size_t)n * 7 + a];
  for (int d = 0; d < rb.D; ++d) x[d] = x0[(size_t)n * rb.D + d];

  if (cfg.warmup_iters > 0)
    ik_lbfgs(rb, w, sc, oH, goal, x, IK_POSE_ONLY, cfg.warmup_iters, cfg.warmup_history,
             cfg.max_step, cfg.n_linesearch, cfg.ls_base, ls_log_ratio);
  if (cfg.mppi_iters > 0) ik_mppi(rb, w, sc, goal, x, cfg, noise, N);
  ik_lbfgs(rb, w, sc, oH, goal, x, 0, cfg.lbfgs_iters, cfg.history, cfg.max_step,
           cfg.n_linesearch, cfg.ls_base, ls_log_ratio);

  IKMetrics met;
  float c = ik_eval(rb, w, sc, goal, x, nullptr, IK_METRICS, &met);
  bool oob = false;
  for (int d = 0; d < rb.D; ++d) {
    oob = oob || (x[d] < rb.dof_f[6 * d] - 1e-4f) || (x[d] > rb.dof_f[6 * d + 1] + 1e-4f);
    x_out[(size_t)n * rb.D + d] = x[d];
  }
  cost[n] = c;
  pos_err[n] = sqrtf(fmaxf(met.pe2, 1e-16f));
  rot_err[n] = sqrtf(fmaxf(met.re2, 1e-16f));
  feas[n] = (met.min_clear >= 0.0f && met.self_viol <= 0.0f && !oob) ? 1.0f : 0.0f;
}

// The standard normals that ik_solve draws for its MPPI stage when it is given
// no noise: out (iters, particles, N, D).
__global__ void ik_philox_normal_kernel(unsigned int k0, unsigned int k1, int N, int iters,
                                        int particles, int D, float* __restrict__ out) {
  size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t total = (size_t)iters * particles * N;
  if (idx >= total) return;
  int n = (int)(idx % N);
  int pi = (int)((idx / N) % particles);
  int it = (int)(idx / ((size_t)N * particles));
  float eps[IK_MAXD];
  ik_normals(k0, k1, n, it, pi, D, eps);
  for (int d = 0; d < D; ++d) out[idx * D + d] = eps[d];
}

extern "C" {

int ik_max_dof() { return IK_MAXD; }

int ik_block_size() { return IK_BLOCK; }

// floats of scratch one thread needs: evaluation state + L-BFGS history; the
// buffer holds that many for every thread of every (whole) block
int ik_scratch_slots(int L, int S, int D, int H) {
  return ik_eval_slots(L, S) + ik_hist_slots(H, D);
}

int ik_cost_grad_launch(const IKRobot* rb, const IKWorld* w, const float* goal7, const float* q,
                        float* cost, float* grad, float* scratch, int slots, int N,
                        int want_grad, void* stream) {
  if (N <= 0) return 0;
  int blocks = (N + IK_BLOCK - 1) / IK_BLOCK;
  ik_cost_grad_kernel<<<blocks, IK_BLOCK, 0, (cudaStream_t)stream>>>(
      *rb, *w, goal7, q, cost, grad, scratch, slots, N, want_grad);
  return (int)cudaGetLastError();
}

int ik_solve_launch(const IKRobot* rb, const IKWorld* w, const IKSolveCfg* cfg, const float* goal7,
                    const float* x0, const float* noise, float* x_out, float* cost,
                    float* pos_err, float* rot_err, float* feas, float* scratch,
                    int slots, int N, void* stream) {
  if (N <= 0) return 0;
  int blocks = (N + IK_BLOCK - 1) / IK_BLOCK;
  ik_solve_kernel<<<blocks, IK_BLOCK, 0, (cudaStream_t)stream>>>(
      *rb, *w, *cfg, goal7, x0, noise, x_out, cost, pos_err, rot_err, feas, scratch, slots, N);
  return (int)cudaGetLastError();
}

int ik_philox_normal_launch(unsigned int seed_lo, unsigned int seed_hi, int N, int iters,
                            int particles, int D, float* out, void* stream) {
  long long total = (long long)iters * particles * N;
  if (total <= 0) return 0;
  int blocks = (int)((total + 127) / 128);
  ik_philox_normal_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(seed_lo, seed_hi, N, iters,
                                                                    particles, D, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
