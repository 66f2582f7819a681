"""Reference for the trajectory solve of the PyTorch package's tests: the JAX
package's in-kernel optimizer loops (`PallasIKCost._mppi_loop`,
`_lbfgs_loop`) over the blast trajectory objective, with the knot clip and
noise smoothing of `PallasTrajCost.build_solver` (`pallas_traj.py:693-720`).

The loops run as Python loops (lax.fori_loop replaced while they run) around
two jitted functions, the objective with its metrics and its gradient, so one
compile serves every call. Tracing the Pallas body `_lane_eval` instead costs
38 s of compile and 8.5 s per gradient evaluation on the CPU; blast is what
the JAX package holds `_lane_eval` to (`tests/test_pallas_traj.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np

from curobo_tpu.ops.blast import BlastRollout
from curobo_tpu.ops.pallas_ik import PallasIKCost
from curobo_tpu.rollout.robot_rollout import Goal
from curobo_tpu.solver.trajopt import TrajOptConfig, TrajOptSolver
from curobo_tpu.transition.bspline import BSplineTransition
from curobo_tpu.types.pose import Pose

SUB, LANE = 8, 128  # the layout the JAX loops keep their per-problem state in


def _python_fori(lo, hi, body, carry):
    for i in range(int(lo), int(hi)):
        carry = body(jnp.int32(i), carry)
    return carry


class JaxLoopSolver:
    """solve(goal7, x0, q_start, q_end, dt, ...) for N <= LANE trajectories
    (numpy in, numpy out): (x, cost, pos_err, rot_err, feasible, dt_retimed),
    N problems on the lanes, copies on the sublanes."""

    def __init__(self, params, rollout_cfg, bspline, world, pin_goal):
        self.D = params.n_dof
        self.n_free = bspline.n_free_cspace if pin_goal else bspline.n_free
        self.nfD = self.n_free * self.D
        self.pin = pin_goal
        self._loops = PallasIKCost(params, rollout_cfg, world)
        blast = BlastRollout(params, rollout_cfg)
        tr = BSplineTransition(bspline)
        retimer = TrajOptSolver.__new__(TrajOptSolver)
        retimer.params, retimer.cfg = params, TrajOptConfig()
        self._lo, self._hi = params.dof_clip_bounds()
        D, n_free = self.D, self.n_free

        def evaluate(x, goal7, qs, qe, dt):
            knots = x[:, 0, :].T.reshape(LANE, n_free, D)
            traj = tr.rollout(knots, qs, dt, q_goal=qe if pin_goal else None)
            goal = Goal.from_pose(Pose(goal7[:, :3], goal7[:, 3:]))
            res = blast.evaluate_trajectory(world, goal, traj)
            cost = jnp.broadcast_to(res.cost[None], (SUB, LANE))
            return cost, res.pos_err, res.rot_err, res.feasible, retimer._retime_dt(traj, dt)

        def cost_grad(x, *args):
            c, vjp = jax.vjp(lambda xx: evaluate(xx, *args)[0], x)
            return c, vjp(jnp.ones_like(c) / SUB)[0]

        self._evaluate = jax.jit(evaluate)
        self._cost_grad = jax.jit(cost_grad)

    def _clip(self, x):  # knot row r -> dof r % D
        D = self.D
        return jnp.stack([jnp.clip(x[r], self._lo[r % D], self._hi[r % D]) for r in range(self.nfD)])

    def _smooth(self, L):
        D, n_free = self.D, self.n_free

        def f(eps):
            rows = []
            for k in range(n_free):
                for d in range(D):
                    acc = None
                    for j in range(n_free):
                        w = float(L[k, j])
                        if abs(w) < 1e-8:
                            continue
                        t = w * eps[j * D + d]
                        acc = t if acc is None else acc + t
                    rows.append(acc if acc is not None else jnp.zeros_like(eps[0]))
            return jnp.stack(rows)

        return f

    @staticmethod
    def _pad(a):
        a = np.asarray(a)
        return np.concatenate([a, np.repeat(a[:1], LANE - a.shape[0], 0)], 0)

    def _lanes(self, a):  # (N, n) -> (n, SUB, LANE)
        a = self._pad(a)
        return jnp.broadcast_to(jnp.asarray(a.T)[:, None, :], (a.shape[1], SUB, LANE))

    def solve(self, goal7, x0, q_start, q_end, dt, lbfgs_iters, history, n_ls, max_step,
              ls_base=1.0, ls_ratio=0.35, noise=None, L=None, mppi=None):
        """mppi: (iters, particles, init_std, std_decay, min_std, temperature,
        step_size) with noise (iters, particles, N, n) standard normals."""
        N = np.asarray(x0).shape[0]
        args = tuple(jnp.asarray(self._pad(a)) for a in (goal7, q_start,
                                                         q_start if q_end is None else q_end, dt))
        cost_fn = lambda x: self._evaluate(x, *args)[0]
        cost_grad = lambda x: self._cost_grad(x, *args)
        x = self._lanes(x0)
        old = jax.lax.fori_loop
        jax.lax.fori_loop = _python_fori
        try:
            if mppi is not None:
                iters, particles = mppi[0], mppi[1]
                stream = [self._lanes(noise[i, p]) for i in range(iters) for p in range(particles)]
                x, _ = self._loops._mppi_loop(
                    cost_fn, self._clip, x, *mppi,
                    rng=(0, lambda i, shape: (i + 1, stream[i])),
                    eps_transform=None if L is None else self._smooth(L),
                )
            bx, _ = self._loops._lbfgs_loop(cost_fn, self._clip, x, lbfgs_iters, history, max_step,
                                            n_ls, ls_base, ls_ratio, cost_grad=cost_grad)
        finally:
            jax.lax.fori_loop = old
        cost, pe, re, fe, dt_ret = self._evaluate(bx, *args)
        out = (cost[0], pe, re, fe, dt_ret)
        return (np.asarray(bx[:, 0, :N]).T,) + tuple(np.asarray(a)[:N] for a in out)
