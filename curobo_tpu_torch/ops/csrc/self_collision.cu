// Self-collision over a robot's sphere-pair list, for every candidate
// configuration of a batch: the humanoid-scale pair sum of the generic
// objective, its gradient and the largest violation of its metrics. Plain C
// entry points (loaded with ctypes).
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
// because Mosaic has no gather; here the spheres are cut into tiles of SC_TS
// and every pair of two tiles is evaluated from shared memory. The distance
// is the generic path's sqrt(max(d2, 1e-12)) (curobo_tpu/geom/
// self_collision.py:60), which these kernels replace in this package; the
// matmul mode's sqrt(d2 + 1e-12) differs from it by at most 1e-6 m, and only
// where two centres coincide.
//
// Inputs: sphere positions sphere-major, pt (S, 3, N) (element (s, c, n) at
// (s * 3 + c) * N + n), and tile tables built once per robot and device
// (ops/self_collision_kernels.py:tile_tables). The forward takes the live
// tiles (I, J), I <= J, in (I, J) order, each with a dense SC_TS x SC_TS
// margin block, [j][i] the margin of the pair (I * SC_TS + i, J * SC_TS + j)
// and -inf where there is no live pair. The gradient takes per sphere tile I
// its partner tiles J in order (a CSR over I) with the margin of the pair
// {I * SC_TS + i, J * SC_TS + j} at [j][i] (the diagonal block symmetric).
//
// What bounds them on an H100 (NVIDIA H100 80GB HBM3, 700 W). The first
// design (one warp per pair group, 32 candidates on the lanes, both spheres of
// every pair read through L1/L2) was bound by those bytes, not by
// operations: at the G1 line search (4800 candidates x 162 111 pairs) its
// forward moved 768 B a pair per warp, 18.7 GB a launch, in 2.07 ms (about
// 9 TB/s), and its gradient read them twice behind a chain of three dependent
// loads (3.92 ms). Here a block stages each partner tile's positions for its
// candidates (12 KB at 32 candidates) and margin block (4 KB) in shared memory
// with cp.async, double-buffered over its tiles, and each thread keeps SC_K
// spheres of its own tile in registers, so one shared load of a partner serves
// SC_K pairs: by count from the shapes (not a reading), 0.60 GB a forward
// launch and 1.16 GB a gradient launch at that shape. What sets their time
// now is the work inside the hinge: the brackets of
// tools/torch_sc_kernels_ab.py at that shape (PERF.md section 6) read the
// time with no pair inside the hinge (staging, barriers and the prefilter
// alone) at a quarter of the time at the objective's activation, and the
// time with every pair on the exact path at twice it; the exact path's
// branch runs when any of a warp's 32 candidates needs it. Whether the FP32
// pipe or shared-memory loads limit that path is not measured (no profiler
// counters on that machine). The tensor cores do not serve: the squared
// distance of a difference has no full-fp32 route through them, and the
// port takes no TF32.
//
// What the design does about the FP32 work:
// - the prefilter is 6 operations a pair: (1 - 2^-17)(|p|^2 + |q|^2) - 2 p.q
//   from -2 p and the scaled norms (registers and shared memory), against
//   the squared threshold (margin + act)^2 with slack 1e-5. Its rounding
//   error is at most 2^-21 (|p|^2 + |q|^2), a sixteenth of the amount taken
//   off, so it never exceeds the differences' squared distance: a pair it
//   puts beyond the threshold adds exactly 0 and no live pair is cut (far
//   from the origin, at |p| of tens of metres, more pairs pass it and the
//   result stays the same);
// - the exact path takes the differences and one rsqrtf (MUFU, 2 ulp): dist
//   = d2 rsqrt(d2) and, in the gradient, g / dist = g rsqrt(d2), instead of
//   an IEEE square root and division, which set the time of the exact path
//   in an earlier version of this design;
// - each warp turns its own four columns of the margin block into squared
//   thresholds and a ballot mask of the partner rows with a live pair, and
//   walks only those rows (dead pairs, -inf margin, and a tile's own lower
//   half cost nothing); two barriers a tile.
//
// Mapping: a block is 8 warps over one column of CW candidates; warp w holds
// spheres SC_K w ... SC_K w + 3 of the tile. CW is the smallest power of two
// that holds N, at most 32: the 32 / CW lane slots of a warp walk the partner
// spheres j = slot, slot + 32 / CW, ..., so that fewer than half the lanes
// sit idle at N < 32 (7 candidates: 4 slots of 8 lanes). The forward cuts the
// tile list into `groups` runs of `per_group` tiles, one block row each (about
// four waves of blocks); the gradient cuts a sphere tile's partner list into
// `splits` runs (a small batch fills the card that way), writes partials
// (splits, S, 3, N) and sums them in order in a second pass. The launch
// geometry comes from the wrapper (launch_geometry: a function of N, S and
// the tables' shape only).
//
// Every sum runs in a fixed order (a thread's pairs in tile and partner order;
// lane slots by a fixed xor tree; warps, groups and splits in order), with no
// atomics, so two launches on the same inputs give the same bits. Every entry
// launches on the given stream, does not synchronise, allocates nothing, and
// returns the CUDA error of the launch (0 on success).
#include <cuda_runtime.h>

#include <cstdint>

#define SC_TS 32                     // spheres per tile
#define SC_TSP 36                    // pitch of a staged margin row: rows 4 banks apart
#define SC_WARPS 8
#define SC_K 4                       // spheres a thread keeps in registers
#define SC_THREADS (SC_WARPS * 32)   // SC_WARPS * SC_K == SC_TS
#define SC_EPS2 1e-12f
#define SC_SLACK 1.00001f            // of the squared threshold: no live pair is cut
// 1 - 2^-17: the prefilter's squared distance |p|^2 + |q|^2 - 2 p.q is taken
// less 2^-17 (|p|^2 + |q|^2), 16 times the bound of its rounding error, so it
// never exceeds the squared distance of the differences
#define SC_NORM_SCALE 0.9999923706054688f

// Shared memory of a block, in floats: two stages, each the partner tile's
// positions (SC_TS, 3, CW) and its margin block (SC_TS rows of pitch SC_TSP,
// as copied); then, for the tile being evaluated, the squared thresholds
// (same layout) and the scaled norms of the partner spheres (SC_TS, CW).
template <int CW>
struct ScSmem {
  static constexpr int POS = SC_TS * 3 * CW;
  static constexpr int BLK = SC_TS * SC_TSP;
  static constexpr int STAGE = POS + BLK;
  static constexpr int H = 2 * STAGE;
  static constexpr int NQ = H + BLK;
  static constexpr size_t BYTES = (NQ + SC_TS * CW) * sizeof(float);
};

__device__ __forceinline__ unsigned sc_smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies of 16 or 4 bytes into shared memory; an invalid source fills zeros.
__device__ __forceinline__ void sc_cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sc_smem(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void sc_cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sc_smem(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void sc_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void sc_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Start the copy of partner tile J (candidates n0 ... n0 + CW - 1) and its
// margin block into stage `st`. Spheres at or past S and candidates at or past
// N read zeros. vec: N % 4 == 0 and pt 16-byte aligned (sc_vec), so CW >= 4
// and every row of CW floats is whole aligned 16-byte pieces.
template <int CW>
__device__ __forceinline__ void sc_stage(float* st, const float* __restrict__ pt,
                                         const float* __restrict__ blk, int J, int n0, int N, int S,
                                         bool vec) {
  const int tid = threadIdx.x;
  const float* tile = pt + (size_t)J * SC_TS * 3 * N;
  if (CW >= 4 && vec) {
    constexpr int Q = CW >= 4 ? CW / 4 : 1;
    for (int u = tid; u < SC_TS * 3 * Q; u += SC_THREADS) {
      const int r = u / Q, q = u - r * Q;  // row r = 3 j + c of the tile
      const int n = n0 + 4 * q;
      const bool ok = J * SC_TS + r / 3 < S && n < N;
      sc_cp16(st + r * CW + 4 * q, ok ? tile + (size_t)r * N + n : pt, ok);
    }
  } else {
    for (int u = tid; u < SC_TS * 3 * CW; u += SC_THREADS) {
      const int r = u / CW, q = u - r * CW;
      const int n = n0 + q;
      const bool ok = J * SC_TS + r / 3 < S && n < N;
      sc_cp4(st + u, ok ? tile + (size_t)r * N + n : pt, ok);
    }
  }
  // SC_THREADS == SC_TS * SC_TS / 4: one 16-byte piece of the block a thread
  const int j = tid >> 3, q = tid & 7;
  sc_cp16(st + ScSmem<CW>::POS + j * SC_TSP + 4 * q, blk + j * SC_TS + 4 * q, true);
}

// On arrival of a stage: warp w turns its own four columns of the margin
// block (spheres SC_K w ... of its tile; lane j takes row j) into squared
// thresholds ((margin + act)^2 with slack, -1 where margin + act <= 0, so that
// no distance passes: dist >= 1e-6) and returns the mask of the partner rows
// with a live pair among them; all threads then take the scaled norms of the
// partner spheres. The caller synchronises the block before reading them.
template <int CW>
__device__ __forceinline__ unsigned sc_prepare(const float* st, float* smem, float act, int i0,
                                               int lane) {
  const float4 m = *reinterpret_cast<const float4*>(st + ScSmem<CW>::POS + lane * SC_TSP + i0);
  const float t[SC_K] = {m.x + act, m.y + act, m.z + act, m.w + act};
  float h[SC_K];
#pragma unroll
  for (int kk = 0; kk < SC_K; ++kk) h[kk] = t[kk] > 0.0f ? t[kk] * t[kk] * SC_SLACK : -1.0f;
  *reinterpret_cast<float4*>(smem + ScSmem<CW>::H + lane * SC_TSP + i0) =
      make_float4(h[0], h[1], h[2], h[3]);
  const unsigned live = __ballot_sync(0xffffffffu, fmaxf(fmaxf(h[0], h[1]), fmaxf(h[2], h[3])) >= 0.0f);
  for (int e = threadIdx.x; e < SC_TS * CW; e += SC_THREADS) {
    const int j = e / CW, c = e - j * CW;
    const float qx = st[(3 * j) * CW + c], qy = st[(3 * j + 1) * CW + c], qz = st[(3 * j + 2) * CW + c];
    smem[ScSmem<CW>::NQ + e] = SC_NORM_SCALE * (qx * qx + qy * qy + qz * qz);
  }
  return live;
}

// The partner rows of lane slot `slot` among 32 / CW slots: j = slot mod 32 / CW.
template <int CW>
__device__ __forceinline__ unsigned sc_slot_rows(int slot) {
  unsigned rows = 0;
#pragma unroll
  for (int j = 0; j < SC_TS; j += 32 / CW) rows |= 1u << j;
  return rows << slot;
}

// The SC_K spheres of tile I that this thread holds, for candidate n: -2 p
// (exact; p = -0.5 of it, exact too) and the scaled norm.
__device__ __forceinline__ void sc_load_own(const float* __restrict__ pt, int I, int i0, int n,
                                            int N, int S, float* mx, float* my, float* mz,
                                            float* np) {
#pragma unroll
  for (int kk = 0; kk < SC_K; ++kk) {
    const int s = I * SC_TS + i0 + kk;
    const bool ok = s < S && n < N;
    const float* p = pt + (size_t)s * 3 * N + n;
    const float x = ok ? p[0] : 0.0f, y = ok ? p[N] : 0.0f, z = ok ? p[2 * N] : 0.0f;
    mx[kk] = -2.0f * x;
    my[kk] = -2.0f * y;
    mz[kk] = -2.0f * z;
    np[kk] = SC_NORM_SCALE * (x * x + y * y + z * z);
  }
}

// The prefilter of a pair: (1 - 2^-17)(|p|^2 + |q|^2) - 2 p.q, at most the
// squared distance that the differences give (the bound above), so a pair it
// puts beyond the squared threshold adds exactly 0.
__device__ __forceinline__ float sc_prefilter(float np, float nq, float mx, float my, float mz,
                                              float qx, float qy, float qz) {
  return __fmaf_rn(mz, qz, __fmaf_rn(my, qy, __fmaf_rn(mx, qx, __fadd_rn(np, nq))));
}

// Forward over one group of tiles: the hinge sum (MAX false) or the largest
// clipped violation (MAX true) of each candidate, into part (groups, N).
template <bool MAX, int CW>
__global__ void __launch_bounds__(SC_THREADS, 4)
    sc_fwd_kernel(const float* __restrict__ pt, const int* __restrict__ tiles,
                  const float* __restrict__ blocks, float act, int N, int S, int L, int per_group,
                  bool vec, float* __restrict__ part) {
  extern __shared__ float4 sc_dyn[];
  float* smem = reinterpret_cast<float*>(sc_dyn);
  __shared__ float red[SC_WARPS][CW];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = lane / CW, cand = lane % CW;
  const int n0 = blockIdx.x * CW, n = n0 + cand;
  const int i0 = warp * SC_K;
  const int k0 = blockIdx.y * per_group, k1 = min(L, k0 + per_group);
  const unsigned my_rows = sc_slot_rows<CW>(slot);
  float mx[SC_K], my[SC_K], mz[SC_K], np[SC_K];
  float acc = 0.0f;
  int row = -1;
  if (k0 < k1) sc_stage<CW>(smem, pt, blocks + (size_t)k0 * SC_TS * SC_TS, tiles[2 * k0 + 1], n0, N, S, vec);
  sc_commit();
  for (int k = k0; k < k1; ++k) {
    const float* st = smem + ((k - k0) & 1) * ScSmem<CW>::STAGE;
    const int I = tiles[2 * k];
    if (I != row) {
      row = I;
      sc_load_own(pt, I, i0, n, N, S, mx, my, mz, np);
    }
    sc_wait_all();
    __syncthreads();  // tile k has landed; every warp is done with tile k - 1
    if (k + 1 < k1)
      sc_stage<CW>(smem + ((k + 1 - k0) & 1) * ScSmem<CW>::STAGE, pt,
                   blocks + (size_t)(k + 1) * SC_TS * SC_TS, tiles[2 * k + 3], n0, N, S, vec);
    sc_commit();
    unsigned rows = sc_prepare<CW>(st, smem, act, i0, lane) & my_rows;
    __syncthreads();
    const float* P = st;
    const float* M = st + ScSmem<CW>::POS;
    const float* H = smem + ScSmem<CW>::H;
    const float* NQ = smem + ScSmem<CW>::NQ;
    while (rows) {
      const int j = __ffs(rows) - 1;
      rows &= rows - 1;
      const float4 h4 = *reinterpret_cast<const float4*>(H + j * SC_TSP + i0);
      const float h[SC_K] = {h4.x, h4.y, h4.z, h4.w};
      const float qx = P[(3 * j) * CW + cand], qy = P[(3 * j + 1) * CW + cand],
                  qz = P[(3 * j + 2) * CW + cand], nq = NQ[j * CW + cand];
#pragma unroll
      for (int kk = 0; kk < SC_K; ++kk) {
        if (sc_prefilter(np[kk], nq, mx[kk], my[kk], mz[kk], qx, qy, qz) <= h[kk]) {
          const float dx = -0.5f * mx[kk] - qx, dy = -0.5f * my[kk] - qy, dz = -0.5f * mz[kk] - qz;
          const float d2 = fmaxf(dx * dx + dy * dy + dz * dz, SC_EPS2);
          const float dist = d2 * rsqrtf(d2);
          const float t = M[j * SC_TSP + i0 + kk] + act;
          acc = MAX ? fmaxf(acc, t - dist) : acc + fmaxf(t - dist, 0.0f);
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off >= CW; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, acc, off);
    acc = MAX ? fmaxf(acc, o) : acc + o;
  }
  if (slot == 0) red[warp][cand] = acc;
  __syncthreads();
  if (threadIdx.x < CW && n < N) {
    float r = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < SC_WARPS; ++w) r = MAX ? fmaxf(r, red[w][threadIdx.x]) : r + red[w][threadIdx.x];
    part[(size_t)blockIdx.y * N + n] = r;
  }
}

// Gradient of sphere tile I over one run of its partner tiles: a live pair
// (dist < margin + act, d2 > 1e-12) adds -(g_n / dist) (p_s - p_q) to sphere
// s, q its partner. Writes out[split] (S, 3, N).
template <int CW>
__global__ void __launch_bounds__(SC_THREADS, 3)
    sc_grad_kernel(const float* __restrict__ pt, const float* __restrict__ gout,
                   const int* __restrict__ nb_off, const int* __restrict__ nb_tile,
                   const float* __restrict__ blocks, float act, int N, int S, int splits,
                   bool vec, float* __restrict__ out) {
  extern __shared__ float4 sc_dyn[];
  float* smem = reinterpret_cast<float*>(sc_dyn);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = lane / CW, cand = lane % CW;
  const int n0 = blockIdx.x * CW, n = n0 + cand;
  const int i0 = warp * SC_K;
  const int I = blockIdx.y / splits, sp = blockIdx.y - I * splits;
  const int e0 = nb_off[I], e1 = nb_off[I + 1];
  const int per = (e1 - e0 + splits - 1) / splits;
  const int k0 = min(e1, e0 + sp * per), k1 = min(e1, k0 + per);
  const unsigned my_rows = sc_slot_rows<CW>(slot);
  float mx[SC_K], my[SC_K], mz[SC_K], np[SC_K];
  sc_load_own(pt, I, i0, n, N, S, mx, my, mz, np);
  const float go = n < N ? gout[n] : 0.0f;
  float gx[SC_K], gy[SC_K], gz[SC_K];
#pragma unroll
  for (int kk = 0; kk < SC_K; ++kk) gx[kk] = gy[kk] = gz[kk] = 0.0f;
  if (k0 < k1) sc_stage<CW>(smem, pt, blocks + (size_t)k0 * SC_TS * SC_TS, nb_tile[k0], n0, N, S, vec);
  sc_commit();
  for (int k = k0; k < k1; ++k) {
    const float* st = smem + ((k - k0) & 1) * ScSmem<CW>::STAGE;
    sc_wait_all();
    __syncthreads();
    if (k + 1 < k1)
      sc_stage<CW>(smem + ((k + 1 - k0) & 1) * ScSmem<CW>::STAGE, pt,
                   blocks + (size_t)(k + 1) * SC_TS * SC_TS, nb_tile[k + 1], n0, N, S, vec);
    sc_commit();
    unsigned rows = sc_prepare<CW>(st, smem, act, i0, lane) & my_rows;
    __syncthreads();
    const float* P = st;
    const float* M = st + ScSmem<CW>::POS;
    const float* H = smem + ScSmem<CW>::H;
    const float* NQ = smem + ScSmem<CW>::NQ;
    while (rows) {
      const int j = __ffs(rows) - 1;
      rows &= rows - 1;
      const float4 h4 = *reinterpret_cast<const float4*>(H + j * SC_TSP + i0);
      const float h[SC_K] = {h4.x, h4.y, h4.z, h4.w};
      const float qx = P[(3 * j) * CW + cand], qy = P[(3 * j + 1) * CW + cand],
                  qz = P[(3 * j + 2) * CW + cand], nq = NQ[j * CW + cand];
#pragma unroll
      for (int kk = 0; kk < SC_K; ++kk) {
        if (sc_prefilter(np[kk], nq, mx[kk], my[kk], mz[kk], qx, qy, qz) <= h[kk]) {
          // d = p_s - p_q: from the pair's second end exactly the negation of
          // the first end's, so both ends see the same d2 and dist
          const float dx = -0.5f * mx[kk] - qx, dy = -0.5f * my[kk] - qy, dz = -0.5f * mz[kk] - qz;
          const float d2 = dx * dx + dy * dy + dz * dz;
          const float d2c = fmaxf(d2, SC_EPS2);
          const float r = rsqrtf(d2c);
          if (d2c * r < M[j * SC_TSP + i0 + kk] + act && d2 > SC_EPS2) {
            const float c = go * r;
            // the product rounded on its own, then taken away, as the plain
            // version's scatter does
            gx[kk] = __fsub_rn(gx[kk], __fmul_rn(c, dx));
            gy[kk] = __fsub_rn(gy[kk], __fmul_rn(c, dy));
            gz[kk] = __fsub_rn(gz[kk], __fmul_rn(c, dz));
          }
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off >= CW; off >>= 1) {
#pragma unroll
    for (int kk = 0; kk < SC_K; ++kk) {
      gx[kk] = __fadd_rn(gx[kk], __shfl_xor_sync(0xffffffffu, gx[kk], off));
      gy[kk] = __fadd_rn(gy[kk], __shfl_xor_sync(0xffffffffu, gy[kk], off));
      gz[kk] = __fadd_rn(gz[kk], __shfl_xor_sync(0xffffffffu, gz[kk], off));
    }
  }
  if (slot != 0 || n >= N) return;
  float* o = out + (size_t)sp * S * 3 * N;
#pragma unroll
  for (int kk = 0; kk < SC_K; ++kk) {
    const int s = I * SC_TS + i0 + kk;
    if (s < S) {
      float* g = o + (size_t)s * 3 * N + n;
      g[0] = gx[kk];
      g[N] = gy[kk];
      g[2 * N] = gz[kk];
    }
  }
}

// Second pass: the `parts` partials of each of E outputs, in order.
template <bool MAX>
__global__ void sc_sum_parts_kernel(const float* __restrict__ part, int parts, long long E,
                                    float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float r = part[e];
  for (int g = 1; g < parts; ++g) r = MAX ? fmaxf(r, part[(size_t)g * E + e]) : r + part[(size_t)g * E + e];
  out[e] = r;
}

template <bool MAX>
static int sc_sum_parts(const float* part, int parts, long long E, float* out, cudaStream_t stream) {
  sc_sum_parts_kernel<MAX><<<(unsigned)((E + 255) / 256), 256, 0, stream>>>(part, parts, E, out);
  return (int)cudaGetLastError();
}

// Whether the positions may be staged in 16-byte copies: whole pieces per row
// and an aligned start (a contiguous view may begin at any float).
static bool sc_vec(const float* pt, int N) { return (N & 3) == 0 && ((uintptr_t)pt & 15) == 0; }

template <bool MAX, int CW>
static void sc_fwd_launch(const float* pt, const int* tiles, const float* blocks, float act, int N,
                          int S, int L, int groups, int per, float* dst, cudaStream_t stream) {
  dim3 grid((N + CW - 1) / CW, groups);
  sc_fwd_kernel<MAX, CW><<<grid, SC_THREADS, ScSmem<CW>::BYTES, stream>>>(
      pt, tiles, blocks, act, N, S, L, per, sc_vec(pt, N), dst);
}

template <int CW>
static void sc_grad_launch(const float* pt, const float* gout, const int* nb_off, const int* nb_tile,
                           const float* blocks, float act, int N, int S, int splits, float* dst,
                           cudaStream_t stream) {
  const int T = (S + SC_TS - 1) / SC_TS;
  dim3 grid((N + CW - 1) / CW, T * splits);
  sc_grad_kernel<CW><<<grid, SC_THREADS, ScSmem<CW>::BYTES, stream>>>(
      pt, gout, nb_off, nb_tile, blocks, act, N, S, splits, sc_vec(pt, N), dst);
}

#define SC_BY_CW(CW_VAR, CALL)                          \
  switch (CW_VAR) {                                     \
    case 32: CALL(32); break;                           \
    case 16: CALL(16); break;                           \
    case 8: CALL(8); break;                             \
    case 4: CALL(4); break;                             \
    case 2: CALL(2); break;                             \
    case 1: CALL(1); break;                             \
    default: return (int)cudaErrorInvalidValue;         \
  }

// The launch geometry is the wrapper's; it is checked here against N and L.
// cw: the smallest power of two that holds N, at most 32.
static bool sc_cw_ok(int cw, int N) { return N >= 32 ? cw == 32 : cw >= N && cw / 2 < N; }

template <bool MAX>
static int sc_forward(const float* pt, const int* tiles, const float* blocks, float act, int N, int S,
                      int L, int cw, int groups, int per, float* part, float* out, cudaStream_t stream) {
  if (N <= 0) return 0;
  if (L <= 0) return (int)cudaMemsetAsync(out, 0, (size_t)N * sizeof(float), stream);
  if (!sc_cw_ok(cw, N) || groups < 1 || per < 1 || (long long)(groups - 1) * per >= L ||
      (long long)groups * per < L || (groups > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  float* dst = groups > 1 ? part : out;
#define SC_FWD(C) sc_fwd_launch<MAX, C>(pt, tiles, blocks, act, N, S, L, groups, per, dst, stream)
  SC_BY_CW(cw, SC_FWD)
#undef SC_FWD
  const int e = (int)cudaGetLastError();
  if (e != 0 || groups == 1) return e;
  return sc_sum_parts<MAX>(part, groups, N, out, stream);
}

extern "C" {

int sc_pair_cost_launch(const float* pt, const int* tiles, const float* blocks, float act, int N,
                        int S, int L, int cw, int groups, int per_group, float* scratch, float* cost,
                        void* stream) {
  return sc_forward<false>(pt, tiles, blocks, act, N, S, L, cw, groups, per_group, scratch, cost,
                           (cudaStream_t)stream);
}

int sc_pair_viol_launch(const float* pt, const int* tiles, const float* blocks, int N, int S, int L,
                        int cw, int groups, int per_group, float* scratch, float* viol,
                        void* stream) {
  return sc_forward<true>(pt, tiles, blocks, 0.0f, N, S, L, cw, groups, per_group, scratch, viol,
                          (cudaStream_t)stream);
}

int sc_pair_grad_launch(const float* pt, const float* gout, const int* nb_off, const int* nb_tile,
                        const float* blocks, float act, int N, int S, int L, int cw, int splits,
                        float* scratch, float* grad, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= 0 || S <= 0) return 0;
  if (L <= 0) return (int)cudaMemsetAsync(grad, 0, (size_t)S * 3 * N * sizeof(float), st);
  if (!sc_cw_ok(cw, N) || splits < 1 || (splits > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  float* dst = splits > 1 ? scratch : grad;
#define SC_GRAD(C) sc_grad_launch<C>(pt, gout, nb_off, nb_tile, blocks, act, N, S, splits, dst, st)
  SC_BY_CW(cw, SC_GRAD)
#undef SC_GRAD
  const int e = (int)cudaGetLastError();
  if (e != 0 || splits == 1) return e;
  return sc_sum_parts<false>(scratch, splits, (long long)S * 3 * N, grad, st);
}

}  // extern "C"
