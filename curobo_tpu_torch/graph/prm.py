"""Batched PRM graph planner: batched feasibility on the device, graph search
on the host.

Counterpart of `curobo_tpu/graph/prm.py` (reference `PRMGraphPlanner`,
`graph_planner/graph_planner_prm.py:39`): Halton nodes (bit-equal to the JAX
package's), batched node and swept-edge collision checks (plain PyTorch over
`compute_kinematics`, `sphere_clearance` and `self_collision_distance`), kNN
wiring, roadmap growth with informed (ellipsoidal) and uniform samples when a
start and goal do not connect, scipy `dijkstra` on the host, path
shortcutting, and fixed-length waypoint paths for trajectory seeding. PyTorch
runs eagerly, so the batches are checked at their own size (the JAX package
pads them to powers of two only to stop retracing).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra

from curobo_tpu_torch.geom import world as world_mod
from curobo_tpu_torch.geom.self_collision import self_collision_distance
from curobo_tpu_torch.robot import kinematics as kin_mod
from curobo_tpu_torch.robot.params import KinematicsParams
from curobo_tpu_torch.util.sampling import halton_sequence


@dataclasses.dataclass(frozen=True)
class PRMConfig:
    n_nodes: int = 384
    k_neighbors: int = 10
    edge_substeps: int = 8  # collision checks per edge
    max_path_nodes: int = 12  # fixed output path length (padded by repeats)
    collision_margin: float = 0.0
    # roadmap growth when start/goal fail to connect: each round adds
    # `growth_nodes` samples, `informed_fraction` of them from the prolate
    # hyperspheroid around the unconnected start-goal pairs, the rest uniform
    growth_rounds: int = 2
    growth_nodes: int = 128
    informed_fraction: float = 0.7
    # transverse diameter of the informed spheroid as a multiple of the
    # start-goal distance
    informed_scale: float = 1.8
    # path shortcutting passes: bypass intermediate waypoints with direct
    # collision-checked edges
    shortcut_rounds: int = 2


@dataclasses.dataclass
class PRMResult:
    paths: torch.Tensor  # (B, max_path_nodes, D) waypoints (padded)
    success: np.ndarray  # (B,) bool
    path_lengths: np.ndarray  # (B,) joint-space lengths


class PRMGraphPlanner:
    def __init__(self, params: KinematicsParams, cfg: PRMConfig = PRMConfig()):
        self.params = params
        self.cfg = cfg
        lo, hi = params.dof_clip_bounds(angular_cap=np.pi)
        self._lo, self._hi = np.asarray(lo), np.asarray(hi)
        h = halton_sequence(cfg.n_nodes, params.n_dof)
        self._nodes = (self._lo + (self._hi - self._lo) * h).astype(np.float32)

    @property
    def device(self) -> torch.device:
        return self.params.device

    # ------------------------------------------------------------------
    def _check_configs(self, world, q: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (...,) bool: collision-free configurations."""
        st = kin_mod.compute_kinematics(self.params, q)
        clear = world_mod.sphere_clearance(world, st.spheres)
        live = st.spheres[..., 3] >= 0
        hit = torch.any((clear < self.cfg.collision_margin) & live, dim=-1)
        self_d = self_collision_distance(self.params.self_collision, st.spheres)
        return ~(hit | (self_d > 0))

    def _check_edge_batch(self, world, qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
        """(E, D), (E, D) -> (E,) bool free. Swept edge check: configurations
        at K substeps plus a conservative sphere 'bubble' between consecutive
        substeps (midpoint sphere inflated by half the sphere's travel), so
        thin obstacles cannot be tunneled between samples."""
        K = self.cfg.edge_substeps
        alphas = torch.linspace(0.0, 1.0, K, dtype=qa.dtype, device=qa.device)[:, None, None]
        pts = qa[None] * (1 - alphas) + qb[None] * alphas  # (K, E, D)
        st = kin_mod.compute_kinematics(self.params, pts)
        sph = st.spheres  # (K, E, S, 4)
        live = sph[..., 3] >= 0
        clear = world_mod.sphere_clearance(world, sph)
        hit = torch.any((clear < self.cfg.collision_margin) & live, dim=-1)
        self_d = self_collision_distance(self.params.self_collision, sph)
        ok_cfg = ~(hit | (self_d > 0))  # (K, E)
        c0, c1 = sph[:-1], sph[1:]
        mid = 0.5 * (c0[..., :3] + c1[..., :3])
        travel = torch.linalg.norm(c1[..., :3] - c0[..., :3], dim=-1)
        infl = c0[..., 3] + 0.5 * travel
        bubble = torch.cat([mid, infl[..., None]], dim=-1)
        bclear = world_mod.sphere_clearance(world, bubble)
        bhit = torch.any((bclear < self.cfg.collision_margin) & live[:-1], dim=-1)  # (K-1, E)
        return torch.all(ok_cfg, dim=0) & torch.all(~bhit, dim=0)

    def _configs_free(self, world, q: np.ndarray) -> np.ndarray:
        if len(q) == 0:
            return np.zeros(0, dtype=bool)
        with torch.no_grad():
            ok = self._check_configs(world, torch.as_tensor(q, device=self.device))
        return ok.cpu().numpy()

    def _edges_free(self, world, qa: np.ndarray, qb: np.ndarray) -> np.ndarray:
        if len(qa) == 0:
            return np.zeros(0, dtype=bool)
        with torch.no_grad():
            ok = self._check_edge_batch(
                world, torch.as_tensor(qa, device=self.device), torch.as_tensor(qb, device=self.device)
            )
        return ok.cpu().numpy()

    # ------------------------------------------------------------------
    def _informed_samples(self, rng, q_start: np.ndarray, q_goal: np.ndarray, n: int) -> np.ndarray:
        """Uniform samples inside the prolate hyperspheroid with foci
        (q_start, q_goal) and transverse diameter `informed_scale * ||g - s||`,
        clipped to the joint box."""
        D = q_start.shape[-1]
        c_min = np.linalg.norm(q_goal - q_start)
        c_max = max(self.cfg.informed_scale * c_min, c_min + 1e-6)
        center = 0.5 * (q_start + q_goal)
        a1 = (q_goal - q_start) / max(c_min, 1e-9)
        M = np.eye(D)
        M[:, 0] = a1
        Q, _ = np.linalg.qr(M)
        # qr may flip the first column's sign
        if np.dot(Q[:, 0], a1) < 0:
            Q[:, 0] = -Q[:, 0]
        r1 = c_max / 2.0
        rk = np.sqrt(max(c_max**2 - c_min**2, 1e-12)) / 2.0
        radii = np.full(D, rk)
        radii[0] = r1
        u = rng.normal(size=(n, D))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        u *= rng.uniform(size=(n, 1)) ** (1.0 / D)
        pts = center + (u * radii) @ Q.T
        return np.clip(pts, self._lo, self._hi).astype(np.float32)

    def _knn_edges(self, nodes: np.ndarray, node_ok: np.ndarray, lo: int = 0):
        """kNN candidate edges among valid nodes; with lo > 0, only pairs
        touching nodes[lo:] (incremental wiring of grown nodes)."""
        N = len(nodes)
        dist = np.linalg.norm(nodes[:, None] - nodes[None], axis=-1)
        dist[~node_ok] = np.inf
        dist[:, ~node_ok] = np.inf
        np.fill_diagonal(dist, np.inf)
        knn = np.argsort(dist, axis=-1)[:, : self.cfg.k_neighbors]
        ea, eb = [], []
        for i in range(N):
            if not node_ok[i]:
                continue
            for j in knn[i]:
                if not np.isfinite(dist[i, j]):
                    continue
                a, b = (i, j) if i < j else (j, i)
                if b < lo:  # both endpoints pre-existing: already wired
                    continue
                ea.append(a)
                eb.append(b)
        if not ea:
            return (np.zeros(0, np.int64),) * 2
        pairs = np.unique(np.stack([ea, eb], axis=-1), axis=0)
        return pairs[:, 0], pairs[:, 1]

    def _endpoint_edges(self, nodes, node_ok, endpoints, which):
        """Candidate connections endpoint -> k nearest valid nodes."""
        sa, sb = [], []
        for e in which:
            d = np.linalg.norm(nodes - endpoints[e], axis=-1)
            d[~node_ok] = np.inf
            near = np.argsort(d)[: self.cfg.k_neighbors]
            for j in near:
                if np.isfinite(d[j]):
                    sa.append(e)
                    sb.append(j)
        return np.asarray(sa, np.int64), np.asarray(sb, np.int64)

    def _shortcut(self, world, wp: np.ndarray) -> np.ndarray:
        """Greedy path shortcutting: one batched sweep checks every skip edge
        (i, j > i + 1); then walk from the start, always jumping to the
        farthest reachable waypoint."""
        M = len(wp)
        if M <= 2:
            return wp
        pairs = [(i, j) for i in range(M - 2) for j in range(i + 2, M)]
        ia = np.asarray([p[0] for p in pairs])
        ib = np.asarray([p[1] for p in pairs])
        free = self._edges_free(world, wp[ia], wp[ib])
        ok = {pair: bool(f) for pair, f in zip(pairs, free)}
        out = [0]
        i = 0
        while i < M - 1:
            nxt = i + 1
            for j in range(M - 1, i + 1, -1):
                if ok.get((i, j), False):
                    nxt = j
                    break
            out.append(nxt)
            i = nxt
        return wp[out]

    # ------------------------------------------------------------------
    def plan(
        self, world: world_mod.WorldData, q_start: torch.Tensor, q_goal: torch.Tensor,
    ) -> PRMResult:
        """q_start, q_goal (B, D) -> fixed-length waypoint paths (B, P, D)."""
        cfg = self.cfg
        B, D = q_start.shape
        rng = np.random.RandomState(0)

        # 1. validate the base roadmap (shared across problems: same world)
        nodes = self._nodes
        node_ok = self._configs_free(world, nodes)

        # 2-3. kNN candidate edges + batched edge collision sweep
        ea, eb = self._knn_edges(nodes, node_ok)
        if len(ea):
            free = self._edges_free(world, nodes[ea], nodes[eb])
            ea, eb = ea[free], eb[free]

        qs = q_start.detach().cpu().numpy().astype(np.float32)
        qg = q_goal.detach().cpu().numpy().astype(np.float32)
        endpoints = np.stack([v for b in range(B) for v in (qs[b], qg[b])])  # (2B, D)

        def wire_endpoints(which):
            sa, sb = self._endpoint_edges(nodes, node_ok, endpoints, which)
            if len(sa):
                free = self._edges_free(world, endpoints[sa], nodes[sb])
                sa, sb = sa[free], sb[free]
            return sa, sb

        all_sa, all_sb = wire_endpoints(range(2 * B))

        def search():
            n_total = len(nodes) + 2 * B
            rows = np.concatenate([ea, eb, all_sa + len(nodes), all_sb])
            cols = np.concatenate([eb, ea, all_sb, all_sa + len(nodes)])
            node_pos = np.concatenate([nodes, endpoints], axis=0)
            w = np.linalg.norm(node_pos[rows] - node_pos[cols], axis=-1)
            graph = csr_matrix((w, (rows, cols)), shape=(n_total, n_total))
            starts = np.asarray([len(nodes) + 2 * b for b in range(B)])
            dists, preds = dijkstra(graph, indices=starts, return_predecessors=True)
            return node_pos, starts, dists, preds

        def unconnected_of(dists):
            return [b for b in range(B) if not np.isfinite(dists[b, len(nodes) + 2 * b + 1])]

        node_pos, starts, dists, preds = search()
        unconnected = unconnected_of(dists)

        # 4. roadmap growth for unconnected problems: informed (ellipsoidal)
        #    samples around each unconnected (start, goal) pair + uniform
        for _ in range(cfg.growth_rounds):
            if not unconnected:
                break
            per = max(cfg.growth_nodes // max(len(unconnected), 1), 8)
            new = []
            for b in unconnected:
                ni = int(per * cfg.informed_fraction)
                new.append(self._informed_samples(rng, qs[b], qg[b], ni))
                new.append(rng.uniform(self._lo, self._hi, (per - ni, D)).astype(np.float32))
            new = np.concatenate(new, axis=0)
            new_ok = self._configs_free(world, new)
            lo_idx = len(nodes)
            nodes = np.concatenate([nodes, new], axis=0)
            node_ok = np.concatenate([node_ok, new_ok])
            # incremental wiring: only edges touching the new nodes
            na, nb = self._knn_edges(nodes, node_ok, lo=lo_idx)
            if len(na):
                free = self._edges_free(world, nodes[na], nodes[nb])
                ea = np.concatenate([ea, na[free]])
                eb = np.concatenate([eb, nb[free]])
            # re-wire the endpoints of the unconnected problems
            sa, sb = wire_endpoints([i for b in unconnected for i in (2 * b, 2 * b + 1)])
            all_sa = np.concatenate([all_sa, sa])
            all_sb = np.concatenate([all_sb, sb])
            node_pos, starts, dists, preds = search()
            unconnected = unconnected_of(dists)

        # 5. extract + shortcut + fixed-length resample
        paths = np.zeros((B, cfg.max_path_nodes, D), dtype=np.float32)
        success = np.zeros(B, dtype=bool)
        lengths = np.full(B, np.inf, dtype=np.float32)
        for b in range(B):
            goal_idx = len(nodes) + 2 * b + 1
            if not np.isfinite(dists[b, goal_idx]):
                # fallback: straight line (lets trajopt try anyway)
                alphas = np.linspace(0, 1, cfg.max_path_nodes)[:, None]
                paths[b] = qs[b] * (1 - alphas) + qg[b] * alphas
                continue
            chain = [goal_idx]
            while chain[-1] != starts[b]:
                chain.append(preds[b, chain[-1]])
            wp = node_pos[chain[::-1]]
            for _ in range(cfg.shortcut_rounds):
                pruned = self._shortcut(world, wp)
                if len(pruned) == len(wp):
                    break
                wp = pruned
            # resample to a fixed node count by arc length
            seg = np.linalg.norm(np.diff(wp, axis=0), axis=-1)
            cum = np.concatenate([[0], np.cumsum(seg)])
            t = np.linspace(0, cum[-1], cfg.max_path_nodes)
            paths[b] = np.stack([np.interp(t, cum, wp[:, d]) for d in range(D)], axis=-1)
            success[b] = True
            lengths[b] = cum[-1]

        return PRMResult(
            paths=torch.as_tensor(paths, device=self.device), success=success, path_lengths=lengths
        )
