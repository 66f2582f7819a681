// The two IK kernels and their plain C entry points (loaded with ctypes).
//
// ik_cost_grad: replaces PallasIKCost._build -> kernel_grad / kernel_fwd
//   (curobo_tpu/ops/pallas_ik.py): cost (N,) and, when asked, grad (N, D).
// Both take goals of 1..IK_MAXT tool frames, (N, 7 T): each tool's position
//   and quaternion in turn (the TPU kernel's `_pack` layout); the pose cost is
//   summed over the tools and the metrics keep the largest error.
// ik_solve: replaces PallasIKCost.build_solver / build_mppi_solver /
//   build_lbfgs_solver: a whole solve per configuration in one launch, pose-only
//   L-BFGS warm-up -> optional MPPI -> full-cost L-BFGS -> metrics. With the
//   other stages' budgets at 0 it is the MPPI-only or the L-BFGS-only solver.
//
// Bound on this card: operations, not bytes (a few hundred bytes in and out per
// configuration against ~1e4..1e7 float operations). Mapping: one warp per
// configuration, IK_WARPS warps per block; the block copies the robot and
// world tables into shared memory once (a world too large for it is compacted
// into global memory once per launch and read there), and each warp
// keeps its evaluation state and its L-BFGS history there. Lane d holds dof d
// of every optimizer vector, so the optimizer's dot products are warp shuffles
// and the evaluation's pairs, spheres and links are split over the lanes
// (ik_device.cuh). The planner's 32 seeds are 32 warps on 8 SMs, a batch of
// 3200 configurations 3200 warps.
//
// Every entry launches on the given stream, does not synchronise, allocates
// nothing, and returns the CUDA error of the launch (0 on success).
#include "ik_device.cuh"

// Warps (configurations) per block. On an NVIDIA H100 80GB HBM3 at 700 W,
// 1, 2, 4 and 8 warps took 8.31 / 8.30 / 8.33 / 9.01 ms at N = 32 and 26.67 /
// 19.74 / 19.79 / 20.55 ms at N = 3200 (default IKConfig budget; PERF.md
// section 6), so 4.
// Naming 4 resident blocks of this size per SM pins the register cap at 128 a
// thread (65536 / (4 * 128)), where a thread count alone lets ptxas trade
// registers (and spills) for more resident blocks.
#define IK_WARPS 4
#define IK_MIN_BLOCKS 4

// evaluation state, goal slot (goal and per-tool error scratch), L-BFGS history
__host__ __device__ inline int ik_warp_words(int L, int S, int hist) {
  return ik_layout(L, S).words + IK_GOAL_WORDS + IK_TERR_WORDS + hist;
}

__global__ void __launch_bounds__(32 * IK_WARPS, IK_MIN_BLOCKS)
ik_cost_grad_kernel(IKRobot rbg, IKWorld wg, const float* wglob, const float* __restrict__ goal7,
                    const float* __restrict__ q, float* __restrict__ cost,
                    float* __restrict__ grad, int N, int want_grad) {
  extern __shared__ float smem[];
  __shared__ IKRobot rb;
  __shared__ IKWorld w;
  float* base = ik_load_tables(rbg, wg, wglob, smem, rb, w);
  const int lane = ik_lane(), warp = threadIdx.x >> 5;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= N) return;
  float* st = base + warp * ik_warp_words(rb.L, rb.S, 0);
  float* goal = st + ik_layout(rb.L, rb.S).words;
  const int G = 7 * rb.n_tools;
  if (lane < G) goal[lane] = goal7[(size_t)n * G + lane];
  __syncwarp();
  const float x = lane < rb.D ? q[(size_t)n * rb.D + lane] : 0.0f;
  float g = 0.0f;
  const float c = ik_eval(rb, w, st, goal, x, g, want_grad ? IK_WANT_GRAD : 0, nullptr);
  if (lane == 0) cost[n] = c;
  if (want_grad && lane < rb.D) grad[(size_t)n * rb.D + lane] = g;
}

__global__ void __launch_bounds__(32 * IK_WARPS, IK_MIN_BLOCKS)
ik_solve_kernel(IKRobot rbg, IKWorld wg, const float* wglob, IKSolveCfg cfg,
                const float* __restrict__ goal7,
                const float* __restrict__ x0, const float* __restrict__ noise,
                float* __restrict__ x_out, float* __restrict__ cost, float* __restrict__ pos_err,
                float* __restrict__ rot_err, float* __restrict__ feas, int N, int hist_m) {
  extern __shared__ float smem[];
  __shared__ IKRobot rb;
  __shared__ IKWorld w;
  float* base = ik_load_tables(rbg, wg, wglob, smem, rb, w);
  const int lane = ik_lane(), warp = threadIdx.x >> 5;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= N) return;
  const int D = rb.D;
  float* st = base + warp * ik_warp_words(rb.L, rb.S, ik_hist_words(hist_m, D));
  float* goal = st + ik_layout(rb.L, rb.S).words;
  float* hist = goal + IK_GOAL_WORDS + IK_TERR_WORDS;
  const int G = 7 * rb.n_tools;
  if (lane < G) goal[lane] = goal7[(size_t)n * G + lane];
  __syncwarp();
  const float ls_log_ratio = logf(cfg.ls_ratio);
  float x = lane < D ? x0[(size_t)n * D + lane] : 0.0f;

  if (cfg.warmup_iters > 0)
    ik_lbfgs(rb, w, st, hist, goal, x, IK_POSE_ONLY, cfg.warmup_iters, cfg.warmup_history,
             cfg.max_step, cfg.n_linesearch, cfg.ls_base, ls_log_ratio);
  if (cfg.mppi_iters > 0) ik_mppi(rb, w, st, goal, x, cfg, noise, n, N);
  ik_lbfgs(rb, w, st, hist, goal, x, 0, cfg.lbfgs_iters, cfg.history, cfg.max_step,
           cfg.n_linesearch, cfg.ls_base, ls_log_ratio);

  IKMetrics met;
  float gdummy;
  const float c = ik_eval(rb, w, st, goal, x, gdummy, IK_METRICS, &met);
  bool oob = false;
  if (lane < D) {
    oob = (x < rb.dof_f[6 * lane] - 1e-4f) || (x > rb.dof_f[6 * lane + 1] + 1e-4f);
    x_out[(size_t)n * D + lane] = x;
  }
  oob = __any_sync(IK_FULL, oob);
  if (lane == 0) {
    cost[n] = c;
    pos_err[n] = sqrtf(fmaxf(met.pe2, 1e-16f));
    rot_err[n] = sqrtf(fmaxf(met.re2, 1e-16f));
    feas[n] = (met.min_clear >= 0.0f && met.self_viol <= 0.0f && !oob) ? 1.0f : 0.0f;
  }
}

// The standard normals that ik_solve draws for its MPPI stage when it is given
// no noise: out (iters, particles, N, D), one thread per value.
__global__ void ik_philox_normal_kernel(unsigned int k0, unsigned int k1, int N, int iters,
                                        int particles, int D, float* __restrict__ out) {
  size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t total = (size_t)iters * particles * N * D;
  if (idx >= total) return;
  size_t row = idx / D;
  int d = (int)(idx % D);
  int n = (int)(row % N);
  int pi = (int)((row / N) % particles);
  int it = (int)(row / ((size_t)N * particles));
  out[idx] = ik_normal(k0, k1, n, it, pi, d);
}

// Words of a block's own state beside the tables: each warp's evaluation
// state, goal and L-BFGS history.
static size_t ik_block_words(const IKRobot* rb, int hist) {
  return (size_t)IK_WARPS * ik_warp_words(rb->L, rb->S, hist);
}

// Sets the kernel's shared memory, compacts a world that does not fit into
// `wbuf` and returns the kernel's `wglob` and shared bytes (*err set on a
// refusal).
template <class K>
static const float* ik_prepare(K kernel, const IKRobot* rb, const IKWorld* w, int hist,
                               float* wbuf, cudaStream_t stream, size_t* smem, int* err) {
  const size_t own = ik_block_words(rb, hist);
  const bool fits = ik_world_fits(*rb, *w, own);
  *smem = sizeof(float) * ((size_t)ik_robot_words(*rb) + (fits ? ik_world_words(*w) : 0) + own);
  *err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (*err != 0) return nullptr;
  return ik_stage_world(*w, fits, wbuf, stream, err);
}

static int ik_solve_hist(const IKSolveCfg* cfg) {
  return cfg->history > cfg->warmup_history ? cfg->history : cfg->warmup_history;
}

extern "C" {

int ik_max_dof() { return IK_MAXD; }

// Words of the global buffer a launch needs for its world (0 when the world
// fits in shared memory).
int ik_cost_grad_scratch_words(const IKRobot* rb, const IKWorld* w) {
  return ik_world_fits(*rb, *w, ik_block_words(rb, 0)) ? 0 : ik_world_global_words(*w);
}

int ik_solve_scratch_words(const IKRobot* rb, const IKWorld* w, const IKSolveCfg* cfg) {
  const int hist = ik_hist_words(ik_solve_hist(cfg), rb->D);
  return ik_world_fits(*rb, *w, ik_block_words(rb, hist)) ? 0 : ik_world_global_words(*w);
}

int ik_cost_grad_launch(const IKRobot* rb, const IKWorld* w, const float* goal7, const float* q,
                        float* cost, float* grad, float* scratch, int N, int want_grad,
                        void* stream) {
  if (N <= 0) return 0;
  size_t smem;
  int e;
  const float* wglob =
      ik_prepare(ik_cost_grad_kernel, rb, w, 0, scratch, (cudaStream_t)stream, &smem, &e);
  if (e != 0) return e;
  ik_cost_grad_kernel<<<(N + IK_WARPS - 1) / IK_WARPS, 32 * IK_WARPS, smem,
                        (cudaStream_t)stream>>>(*rb, *w, wglob, goal7, q, cost, grad, N,
                                                want_grad);
  return (int)cudaGetLastError();
}

int ik_solve_launch(const IKRobot* rb, const IKWorld* w, const IKSolveCfg* cfg, const float* goal7,
                    const float* x0, const float* noise, float* x_out, float* cost,
                    float* pos_err, float* rot_err, float* feas, float* scratch, int N,
                    void* stream) {
  if (N <= 0) return 0;
  const int hist_m = ik_solve_hist(cfg);
  size_t smem;
  int e;
  const float* wglob = ik_prepare(ik_solve_kernel, rb, w, ik_hist_words(hist_m, rb->D), scratch,
                                  (cudaStream_t)stream, &smem, &e);
  if (e != 0) return e;
  ik_solve_kernel<<<(N + IK_WARPS - 1) / IK_WARPS, 32 * IK_WARPS, smem, (cudaStream_t)stream>>>(
      *rb, *w, wglob, *cfg, goal7, x0, noise, x_out, cost, pos_err, rot_err, feas, N, hist_m);
  return (int)cudaGetLastError();
}
int ik_philox_normal_launch(unsigned int seed_lo, unsigned int seed_hi, int N, int iters,
                            int particles, int D, float* out, void* stream) {
  long long total = (long long)iters * particles * N * D;
  if (total <= 0) return 0;
  int blocks = (int)((total + 127) / 128);
  ik_philox_normal_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(seed_lo, seed_hi, N, iters,
                                                                    particles, D, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
