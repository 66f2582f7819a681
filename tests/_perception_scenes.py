"""Seeded numpy scenes for the perception tests of both packages: depth frames
of the perception example's box and of the reference bench's tabletop, robot
sphere renders, LiDAR scans, and closed meshes, in numpy for either
package."""

import numpy as np

# the perception example's camera (`examples/perception_to_planning.py`):
# at (-1, 0, 0.5) looking along +x, image y down
EXAMPLE_R = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], dtype=np.float64)
EXAMPLE_ORIGIN = np.array([-1.0, 0.0, 0.5])
EXAMPLE_BOX = (np.array([0.35, -0.15, 0.3]), np.array([0.55, 0.15, 0.6]))


def intrinsics(W, H, fov_deg):
    f = W / (2 * np.tan(np.radians(fov_deg) / 2))
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], dtype=np.float32)


def rot_to_quat(R):
    """Rotation matrix -> wxyz quaternion (numpy, w >= 0)."""
    R = np.asarray(R, dtype=np.float64)
    w = np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12)) / 2
    q = np.array([w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
                  (R[1, 0] - R[0, 1]) / (4 * w)])
    return (q / np.linalg.norm(q)).astype(np.float32)


def camera_rays(W, H, K, R):
    v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    d = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u, float)], -1)
    return d @ R.T  # world directions with camera-frame z = 1


def box_depth(W, H, K, R, origin, box=EXAMPLE_BOX):
    """Depth (camera z) of an axis-aligned box by the slab method; 0 = miss."""
    dirs = camera_rays(W, H, K, R)
    lo, hi = box
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = (lo - origin) / dirs
        t1 = (hi - origin) / dirs
    tmin = np.minimum(t0, t1).max(-1)
    tmax = np.maximum(t0, t1).min(-1)
    hit = (tmax > tmin) & (tmin > 0)
    return np.where(hit, tmin, 0.0).astype(np.float32)


def example_frame(W=80, H=60):
    """(depth, K, position, quaternion) of the perception example's frame."""
    K = intrinsics(W, H, 60.0)
    return (box_depth(W, H, K, EXAMPLE_R, EXAMPLE_ORIGIN), K,
            EXAMPLE_ORIGIN.astype(np.float32), rot_to_quat(EXAMPLE_R))


TABLETOP_SPHERES = (([0.15, 0.1, 1.25], 0.12), ([-0.2, -0.05, 1.3], 0.09),
                    ([0.0, 0.25, 1.2], 0.07))


def tabletop_depth(W, H, K, jitter, rng, plane=1.45, holes=0.0):
    """The reference perception bench's scene (`bench.py:bench_perception`):
    a plane at camera z = 1.45 and three spheres, analytically raycast, plus
    2 mm sensor noise and a share of invalid pixels."""
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    dirs = np.stack([(uu - K[0, 2]) / K[0, 0], (vv - K[1, 2]) / K[1, 1],
                     np.ones_like(uu, np.float64)], -1)
    nrm = np.linalg.norm(dirs, axis=-1)
    z = np.full((H, W), plane)
    for c, r in TABLETOP_SPHERES:
        c = np.asarray(c) + jitter
        b = (dirs * c).sum(-1) / nrm ** 2
        disc = b * b - ((c * c).sum() - r * r) / nrm ** 2
        hit = disc > 0
        t = np.where(hit, b - np.sqrt(np.maximum(disc, 0)), np.inf)
        z = np.minimum(z, np.where(hit, t, np.inf))
    z = (z + rng.normal(0, 0.002, z.shape)).astype(np.float32)
    if holes > 0:
        z[rng.uniform(size=z.shape) < holes] = 0.0
    return z


def tabletop_frame(i, W, H, F, fov_deg=60.0, holes=0.0):
    """Frame i of the bench protocol at W x H with F feature channels:
    (depth, K, rgb, feature), objects moving with i."""
    rng = np.random.RandomState(100 + i)
    K = intrinsics(W, H, fov_deg)
    depth = tabletop_depth(W, H, K, np.asarray([0.02, 0.015, 0.0]) * (i % 4), rng, holes=holes)
    rgb = rng.uniform(size=(H, W, 3)).astype(np.float32)
    feat = rng.uniform(size=(H, W, F)).astype(np.float32)
    return depth, K, rgb, feat


def sphere_depth(W, H, K, R, origin, spheres, plane_t=None):
    """Depth (camera z) of a set of spheres (S, 4) raycast from a camera,
    with an optional background at camera z = plane_t."""
    dirs = camera_rays(W, H, K, R)
    z = np.full((H, W), np.inf if plane_t is None else plane_t)
    nrm2 = (dirs * dirs).sum(-1)
    for c, r in zip(spheres[:, :3], spheres[:, 3]):
        if r < 0:
            continue
        oc = origin - c
        b = (dirs * oc).sum(-1) / nrm2
        disc = b * b - ((oc * oc).sum() - r * r) / nrm2
        t = -b - np.sqrt(np.maximum(disc, 0))
        z = np.minimum(z, np.where((disc > 0) & (t > 0), t, np.inf))
    return np.where(np.isfinite(z), z, 0.0).astype(np.float32)


def lidar_scan(n_az=128, n_el=16, room=(1.5, 1.2, 1.0), seed=0):
    """A spinning LiDAR's returns in the sensor frame from inside a box room
    (half extents `room`), with invalid returns (0, inf and NaN). The beams
    sit half a bin off the mapper's azimuth bin edges: a beam on an edge is a
    tie that float rounding settles either way (the JAX package's own eager
    and compiled range images differ there)."""
    rng = np.random.RandomState(seed)
    az = np.linspace(-np.pi, np.pi, n_az, endpoint=False) + np.pi / n_az
    el = np.linspace(-0.4, 0.4, n_el)
    A, E = np.meshgrid(az, el, indexing="ij")
    d = np.stack([np.cos(E) * np.cos(A), np.cos(E) * np.sin(A), np.sin(E)], -1).reshape(-1, 3)
    with np.errstate(divide="ignore"):
        t = np.min(np.where(d != 0, np.asarray(room) / np.abs(d), np.inf), axis=-1)
    pts = (d * (t + rng.normal(0, 0.003, t.shape))[:, None]).astype(np.float32)
    bad = rng.choice(len(pts), 12, replace=False)
    pts[bad[:4]] = 0.0
    pts[bad[4:8]] = np.inf
    pts[bad[8:]] = np.nan
    return pts


def box_mesh(half):
    """A closed box (8 vertices, 12 outward triangles)."""
    h = np.asarray(half, dtype=np.float64)
    v = np.array([[sx * h[0], sy * h[1], sz * h[2]] for sx in (-1, 1) for sy in (-1, 1)
                  for sz in (-1, 1)])
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
                 dtype=np.int64)
    return v, f


def icosphere(radius, subdivisions=1):
    """A closed icosphere: the icosahedron, midpoint-subdivided, projected."""
    phi = (1 + 5 ** 0.5) / 2
    v = [[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0], [0, -1, phi], [0, 1, phi],
         [0, -1, -phi], [0, 1, -phi], [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]]
    v = [list(np.asarray(p) / np.linalg.norm(p)) for p in v]
    f = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
         [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
         [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    for _ in range(subdivisions):
        mid = {}

        def m(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                p = np.asarray(v[a]) + np.asarray(v[b])
                v.append(list(p / np.linalg.norm(p)))
                mid[key] = len(v) - 1
            return mid[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = m(a, b), m(b, c), m(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        f = nf
    return np.asarray(v, dtype=np.float64) * radius, np.asarray(f, dtype=np.int64)
