// Self-collision over a robot's sphere-pair list, for every candidate
// configuration of a batch: the humanoid-scale pair sum of the generic
// objective and the largest violation of its metrics. Plain C entry points
// (loaded with ctypes).
//
// Replaces the matmul mode of the TPU IK kernels, which PallasIKCost selects
// above 2048 live pairs (curobo_tpu/ops/pallas_ik.py:391-397):
//   sc_pair_cost: PallasIKCost.sc_matmul_cost (pallas_ik.py:710), per
//     candidate n the sum over live pairs of max(margin + activation - dist, 0);
//   sc_pair_grad: its custom_vjp backward, d cost / d positions scaled by the
//     upstream gradient of each candidate, laid out (S, 3, N);
//   sc_pair_viol: PallasIKCost.sc_matmul_viol (pallas_ik.py:789), per
//     candidate the largest max(margin - dist, 0) over the pairs.
// The TPU computed the pair differences as one-hot matmuls on its matrix unit
// because Mosaic has no gather; here each pair is two indexed reads. The
// distance is the generic path's sqrt(max(d2, 1e-12)) (curobo_tpu/geom/
// self_collision.py:60), which these kernels replace in this package; the
// matmul mode's sqrt(d2 + 1e-12) differs from it by at most 1e-6 m, and only
// where two centres coincide.
//
// Inputs: sphere positions sphere-major, pt (S, 3, N) (element (s, c, n) at
// (s * 3 + c) * N + n); the live pairs only, pa, pb (P,) and margin (P,) in
// pair order. The gradient also takes a per-sphere incidence list in CSR form
// built once per robot and device: inc_off (S + 1,), and per entry the pair
// index inc_pair and the end's sign inc_sign (+1 where the sphere is the
// pair's first end, -1 where it is the second), in pair order within a sphere.
//
// What bounds them on an H100: operations, not bytes. The G1 at a line search
// (4800 candidates x 162 111 pairs) reads 39 MB of positions, which stay in
// the 50 MB L2, and evaluates 778 M pair distances, about 12 float operations
// each forward. Mapping: the 32 lanes of a warp take 32 neighbouring
// candidates, so every position read is one coalesced 128-byte line and every
// pair-table read is a broadcast. A block's 8 warps walk its pairs strided by
// 8; the forward splits the pairs into G groups (one block row each) so that
// a handful of candidates (the retargeter's local frames evaluate 7) still
// fills the card, and a second pass reduces the groups. The gradient is a
// gather, not a scatter: one thread per (sphere, candidate) walks the
// sphere's incidence list and recomputes each pair's distance, so every pair
// is evaluated twice (once from each end) and no sum needs an atomic.
// Every sum runs in a fixed order (pairs strided per warp, warps in order,
// groups in order; a sphere's pairs in pair order), so two launches on the
// same inputs give the same bits.
//
// Every entry launches on the given stream, does not synchronise, allocates
// nothing, and returns the CUDA error of the launch (0 on success).
#include <cuda_runtime.h>

// candidates per block (the lanes of a warp) and warps per block
#define SC_LANES 32
#define SC_WARPS 8
// the forward's pair groups: enough blocks to fill the 132 SMs several times
// over, but no group smaller than SC_MIN_GROUP pairs
#define SC_TARGET_BLOCKS 1024
#define SC_MIN_GROUP 64
#define SC_EPS2 1e-12f

// Pair groups of the forward for N candidates and P pairs.
static int sc_groups(int N, int P) {
  if (P <= 0) return 1;
  const int bx = (N + SC_LANES - 1) / SC_LANES;
  int g = (SC_TARGET_BLOCKS + bx - 1) / bx;
  const int g_max = (P + SC_MIN_GROUP - 1) / SC_MIN_GROUP;
  g = g < g_max ? g : g_max;
  if (g < 1) g = 1;
  const int per = (P + g - 1) / g;
  return (P + per - 1) / per;  // no empty group
}

__device__ __forceinline__ float sc_pair_dist(const float* __restrict__ pt, int a, int b, int N,
                                              int n) {
  const float* A = pt + (size_t)a * 3 * N + n;
  const float* B = pt + (size_t)b * 3 * N + n;
  const float dx = A[0] - B[0], dy = A[N] - B[N], dz = A[2 * N] - B[2 * N];
  return sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, SC_EPS2));
}

// Forward over one group of pairs: the hinge sum (MAX false) or the largest
// clipped violation (MAX true) of candidate n, into part (G, N).
template <bool MAX>
__global__ void __launch_bounds__(SC_LANES * SC_WARPS)
    sc_pair_reduce_kernel(const float* __restrict__ pt, const int* __restrict__ pa,
                          const int* __restrict__ pb, const float* __restrict__ margin,
                          float act, int N, int P, int per_group, float* __restrict__ part) {
  __shared__ float red[SC_WARPS][SC_LANES];
  const int n = blockIdx.x * SC_LANES + threadIdx.x;
  const int p0 = blockIdx.y * per_group;
  const int p1 = min(P, p0 + per_group);
  float acc = 0.0f;
  if (n < N) {
    for (int k = p0 + threadIdx.y; k < p1; k += SC_WARPS) {
      const float dist = sc_pair_dist(pt, pa[k], pb[k], N, n);
      if (MAX) {
        acc = fmaxf(acc, margin[k] - dist);
      } else {
        acc += fmaxf((margin[k] + act) - dist, 0.0f);
      }
    }
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    float r = red[0][threadIdx.x];
    for (int w = 1; w < SC_WARPS; ++w) r = MAX ? fmaxf(r, red[w][threadIdx.x]) : r + red[w][threadIdx.x];
    part[(size_t)blockIdx.y * N + n] = r;
  }
}

// Second pass of the forward: the G groups of each candidate, in order.
template <bool MAX>
__global__ void sc_group_reduce_kernel(const float* __restrict__ part, int G, int N,
                                       float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float r = part[n];
  for (int g = 1; g < G; ++g) r = MAX ? fmaxf(r, part[(size_t)g * N + n]) : r + part[(size_t)g * N + n];
  out[n] = r;
}

// Gradient: thread (sphere s, candidate n) sums its pairs' terms in pair
// order. A live pair (dist < margin + act, d2 > 1e-12) adds -(g_n / dist) d
// to its first end and +(g_n / dist) d to its second, d = p_a - p_b.
__global__ void __launch_bounds__(SC_LANES * SC_WARPS)
    sc_pair_grad_kernel(const float* __restrict__ pt, const float* __restrict__ gout,
                        const int* __restrict__ pa, const int* __restrict__ pb,
                        const float* __restrict__ margin, const int* __restrict__ inc_off,
                        const int* __restrict__ inc_pair, const signed char* __restrict__ inc_sign,
                        float act, int N, int S, float* __restrict__ grad) {
  const int n = blockIdx.x * SC_LANES + threadIdx.x;
  const int s = blockIdx.y * SC_WARPS + threadIdx.y;
  if (n >= N || s >= S) return;
  const float* P_s = pt + (size_t)s * 3 * N + n;
  const float sx = P_s[0], sy = P_s[N], sz = P_s[2 * N];
  const float go = gout[n];
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  const int e1 = inc_off[s + 1];
  for (int e = inc_off[s]; e < e1; ++e) {
    const int k = inc_pair[e];
    const bool first = inc_sign[e] > 0;
    const float* Q = pt + (size_t)(first ? pb[k] : pa[k]) * 3 * N + n;
    const float qx = Q[0], qy = Q[N], qz = Q[2 * N];
    // d = p_a - p_b, the same bits from either end
    const float dx = first ? sx - qx : qx - sx;
    const float dy = first ? sy - qy : qy - sy;
    const float dz = first ? sz - qz : qz - sz;
    const float d2 = dx * dx + dy * dy + dz * dz;
    const float dist = sqrtf(fmaxf(d2, SC_EPS2));
    if (dist < margin[k] + act && d2 > SC_EPS2) {
      const float c = go / dist;
      // the product rounded on its own, then added or taken away, as the
      // plain version's scatter does
      const float tx = __fmul_rn(c, dx), ty = __fmul_rn(c, dy), tz = __fmul_rn(c, dz);
      if (first) {
        gx = __fsub_rn(gx, tx); gy = __fsub_rn(gy, ty); gz = __fsub_rn(gz, tz);
      } else {
        gx = __fadd_rn(gx, tx); gy = __fadd_rn(gy, ty); gz = __fadd_rn(gz, tz);
      }
    }
  }
  float* G_s = grad + (size_t)s * 3 * N + n;
  G_s[0] = gx;
  G_s[N] = gy;
  G_s[2 * N] = gz;
}

template <bool MAX>
static int sc_forward(const float* pt, const int* pa, const int* pb, const float* margin,
                      float act, int N, int P, float* part, float* out, cudaStream_t stream) {
  if (N <= 0) return 0;
  const int G = sc_groups(N, P);
  const int per = (P + G - 1) / G;
  dim3 grid((N + SC_LANES - 1) / SC_LANES, G), block(SC_LANES, SC_WARPS);
  sc_pair_reduce_kernel<MAX><<<grid, block, 0, stream>>>(pt, pa, pb, margin, act, N, P, per,
                                                        G > 1 ? part : out);
  int e = (int)cudaGetLastError();
  if (e != 0 || G == 1) return e;
  sc_group_reduce_kernel<MAX><<<(N + 255) / 256, 256, 0, stream>>>(part, G, N, out);
  return (int)cudaGetLastError();
}

extern "C" {

// Floats of the forward's group buffer for N candidates and P pairs (0 when
// one group takes every pair and the first pass writes the result).
long long sc_forward_scratch_words(int N, int P) {
  if (N <= 0 || P <= 0) return 0;
  const int G = sc_groups(N, P);
  return G > 1 ? (long long)G * N : 0;
}

int sc_pair_cost_launch(const float* pt, const int* pa, const int* pb, const float* margin,
                        float act, int N, int P, float* scratch, float* cost, void* stream) {
  return sc_forward<false>(pt, pa, pb, margin, act, N, P, scratch, cost, (cudaStream_t)stream);
}

int sc_pair_viol_launch(const float* pt, const int* pa, const int* pb, const float* margin,
                        int N, int P, float* scratch, float* viol, void* stream) {
  return sc_forward<true>(pt, pa, pb, margin, 0.0f, N, P, scratch, viol, (cudaStream_t)stream);
}

int sc_pair_grad_launch(const float* pt, const float* gout, const int* pa, const int* pb,
                        const float* margin, const int* inc_off, const int* inc_pair,
                        const signed char* inc_sign, float act, int N, int S, float* grad,
                        void* stream) {
  if (N <= 0 || S <= 0) return 0;
  dim3 grid((N + SC_LANES - 1) / SC_LANES, (S + SC_WARPS - 1) / SC_WARPS), block(SC_LANES, SC_WARPS);
  sc_pair_grad_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      pt, gout, pa, pb, margin, inc_off, inc_pair, inc_sign, act, N, S, grad);
  return (int)cudaGetLastError();
}

}  // extern "C"
