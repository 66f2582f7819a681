"""The block-sparse TSDF of the PyTorch package against the JAX package on
the CPU: the hash table (encode, decode, hash, lookup), allocation with
reinsertion and pool exhaustion, single-camera and fused-rig integration
(including both overflow counters), `sample_sdf_sparse`, `extract_dense`,
decay, checkpoints read across the two packages, and `Mapper(storage=
"sparse")`.

Inputs are the reference perception bench's tabletop scene at 80 x 60 with 4
feature channels and 3 % invalid pixels, made by numpy from seeds
(`tests/_perception_scenes.py`), seen by two cameras 30 cm apart; pool 256
blocks of 8^3 voxels of 3 cm, table 1024 slots. Tolerances: `table_key`,
`table_slot`, `pool_coords`, `n_alloc` and both drop counters equal exactly;
TSDF, weight, RGB and features within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import curobo_tpu_torch as ct
from curobo_tpu.perception import block_sparse as jb
from curobo_tpu.perception import mapper as jm
from curobo_tpu.perception import types as jty
from curobo_tpu.types.pose import Pose as JPose
from curobo_tpu_torch.convert import block_sparse_from_numpy
from curobo_tpu_torch.perception import block_sparse as tb
from curobo_tpu_torch.perception import mapper as tm
from curobo_tpu_torch.perception import types as tty
from curobo_tpu_torch.types.pose import Pose as TPose

from _perception_scenes import tabletop_frame

DEV = "cpu"
ATOL = 1e-5
BASE = dict(pool_blocks=256, table_size=1024, voxel_size=0.03, discovery_stride=4,
            rgb_channels=True, feature_channels=4)
CONFIGS = {
    "fits": {},
    "pool_exhausted": dict(pool_blocks=64, table_size=256),
    "dedup_overflow": dict(max_new_blocks_per_frame=40),
    "active_cap": dict(max_active_blocks=32),
}
STATE = ("table_key", "table_slot", "pool_coords", "n_alloc", "dropped_blocks", "dropped_active")


def _obs(i, pos):
    depth, K, rgb, feat = tabletop_frame(i, 80, 60, 4, holes=0.03)
    q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    p = np.asarray(pos, np.float32)
    j = jty.CameraObservation(jnp.asarray(depth), jnp.asarray(K), JPose(jnp.asarray(p), jnp.asarray(q)),
                              rgb=jnp.asarray(rgb), feature=jnp.asarray(feat))
    t = tty.CameraObservation(torch.tensor(depth), torch.tensor(K), TPose(torch.tensor(p), torch.tensor(q)),
                              rgb=torch.tensor(rgb), feature=torch.tensor(feat))
    return j, t


def _rig(i):
    """Frame i of the two cameras."""
    return _obs(i, [0.0, 0.0, -0.2]), _obs(i + 4, [0.3, 0.0, -0.2])


def _assert_same(jg, tg):
    for k in STATE:
        a, b = np.asarray(getattr(jg, k)), getattr(tg, k).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    for k in ("tsdf", "weight", "rgb", "feature"):
        a, b = getattr(jg, k), getattr(tg, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, err_msg=k)


def _cfgs(name):
    kw = dict(BASE, **CONFIGS[name])
    return jb.BlockSparseConfig(**kw), tb.BlockSparseConfig(**kw)


def test_hash_encode_decode_match_jax():
    rng = np.random.RandomState(0)
    bc = rng.randint(-530, 530, (4000, 3)).astype(np.int32)  # some out of range
    kj = jb._encode(jnp.asarray(bc))
    kt = tb._encode(torch.tensor(bc))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert (kt == -1).any() and (kt >= 0).any()
    np.testing.assert_array_equal(tb._decode(kt).numpy(), np.asarray(jb._decode(kj)))
    for T in (256, 1024, 16384):
        np.testing.assert_array_equal(tb._hash(kt, T).numpy(), np.asarray(jb._hash(kj, T)))
    keys = np.asarray([5, 3, -1, 3, 7, 2**30 - 1], np.int32)
    for size in (3, 6, 9):
        np.testing.assert_array_equal(
            tb._unique_padded(torch.tensor(keys), size).numpy(),
            np.asarray(jnp.unique(jnp.asarray(keys), size=size, fill_value=-1)))


def test_allocate_reinsert_and_exhaust_match_jax():
    """Random block coords with duplicates and out-of-range ones into a pool
    of 256: the first batch fits, the same batch again changes nothing, a
    third batch overflows the pool."""
    jc, tc = _cfgs("fits")
    alloc = jax.jit(lambda g, c: jb.allocate_blocks(jc, g, c))
    rng = np.random.RandomState(1)
    jg, tg = jb.make_sparse_grid(jc), tb.make_sparse_grid(tc, DEV)
    first = rng.randint(-20, 20, (400, 3)).astype(np.int32)
    first[300:] = first[:100]  # duplicates
    first[3] = (600, 0, 0)  # out of range: never inserted
    for batch in (first, first, rng.randint(-600, 600, (400, 3)).astype(np.int32)):
        jg, tg = alloc(jg, jnp.asarray(batch)), tb.allocate_blocks(tc, tg, torch.tensor(batch))
        _assert_same(jg, tg)
    assert int(tg.n_alloc) == 256 and int(tg.dropped_blocks) > 0
    keys = torch.tensor(first[:50])
    np.testing.assert_array_equal(tb._lookup(tc, tg, tb._encode(keys)).numpy(),
                                  np.asarray(jb._lookup(jc, jg, jb._encode(jnp.asarray(first[:50])))))


@pytest.mark.parametrize("name", ["fits", "pool_exhausted"])
def test_integrate_camera_sparse_matches_jax(name):
    jc, tc = _cfgs(name)
    step = jax.jit(lambda g, o: jb.integrate_camera_sparse(jc, g, o))
    jg, tg = jb.make_sparse_grid(jc), tb.make_sparse_grid(tc, DEV)
    for i in range(3):
        (jo, to), _ = _rig(i)
        jg, tg = step(jg, jo), tb.integrate_camera_sparse(tc, tg, to)
        _assert_same(jg, tg)
    assert int((tg.weight > 0).sum()) > 5000
    assert (int(tg.dropped_blocks) > 0) == (name == "pool_exhausted")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_integrate_cameras_sparse_matches_jax(name):
    """The fused rig; each overflow shows in its own counter."""
    jc, tc = _cfgs(name)
    step = jax.jit(lambda g, a, b: jb.integrate_cameras_sparse(jc, g, (a, b)))
    jg, tg = jb.make_sparse_grid(jc), tb.make_sparse_grid(tc, DEV)
    for i in range(2):
        (ja, ta), (jb_, tb_) = _rig(i)
        jg, tg = step(jg, ja, jb_), tb.integrate_cameras_sparse(tc, tg, (ta, tb_))
        _assert_same(jg, tg)
    dropped, active = int(tg.dropped_blocks), int(tg.dropped_active)
    assert (dropped > 0) == (name in ("pool_exhausted", "dedup_overflow")), dropped
    assert (active > 0) == (name == "active_cap"), active


@pytest.fixture(scope="module")
def mapped():
    """Both packages' pools after two rig frames (no overflow)."""
    jc, tc = _cfgs("fits")
    step = jax.jit(lambda g, a, b: jb.integrate_cameras_sparse(jc, g, (a, b)))
    jg, tg = jb.make_sparse_grid(jc), tb.make_sparse_grid(tc, DEV)
    for i in range(2):
        (ja, ta), (jb_, tb_) = _rig(i)
        jg, tg = step(jg, ja, jb_), tb.integrate_cameras_sparse(tc, tg, (ta, tb_))
    return jc, tc, jg, tg


def test_sample_extract_and_decay_match_jax(mapped):
    jc, tc, jg, tg = mapped
    pts = np.random.RandomState(2).uniform([-0.4, -0.3, 0.85], [0.7, 0.4, 1.3], (3000, 3)).astype(np.float32)
    a, ao = jb.sample_sdf_sparse(jc, jg, jnp.asarray(pts))
    b, bo = tb.sample_sdf_sparse(tc, tg, torch.tensor(pts))
    np.testing.assert_array_equal(bo.numpy(), np.asarray(ao))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)
    assert 100 < int(bo.sum()) < len(pts)
    dims, origin = (40, 30, 20), (-0.435, -0.345, 0.795)  # pool voxel centres
    a = jb.extract_dense(jc, jg, dims, origin)
    b = tb.extract_dense(tc, tg, dims, origin)
    for k in ("tsdf", "weight", "rgb", "feature"):
        np.testing.assert_allclose(getattr(b, k).numpy(), np.asarray(getattr(a, k)), atol=ATOL, err_msg=k)
    assert int((b.weight > 0).sum()) > 1000
    _assert_same(jb.decay_sparse(jc, jg, 0.01), tb.decay_sparse(tc, tg, 0.01))


def test_checkpoints_cross_both_ways_and_convert(mapped, tmp_path):
    jc, tc, jg, tg = mapped
    j = jb.BlockSparseMapper(jc)
    j.grid = jg
    j.save(str(tmp_path / "jax.npz"))
    t = ct.BlockSparseMapper(tc, device=DEV)
    t.load(str(tmp_path / "jax.npz"))
    _assert_same(jg, t.grid)
    t.save(str(tmp_path / "torch.npz"))
    j2 = jb.BlockSparseMapper(jc)
    j2.load(str(tmp_path / "torch.npz"))
    _assert_same(j2.grid, tg)
    assert t.stats() == j.stats()
    conv = block_sparse_from_numpy({f.name: (None if getattr(jg, f.name) is None
                                             else np.asarray(getattr(jg, f.name)))
                                    for f in dataclasses.fields(jg)}, device=DEV)
    _assert_same(jg, conv)
    with pytest.raises(ValueError, match="block_size"):
        ct.BlockSparseMapper(dataclasses.replace(tc, block_size=4), device=DEV).load(
            str(tmp_path / "jax.npz"))


def test_mapper_sparse_storage_matches_jax():
    """`Mapper(storage="sparse")`: one camera, then the rig, the dense view,
    its ESDF and decay, against the JAX mapper. The window's voxel centres are
    the pool's ((k + 0.5) * 3 cm): a window offset by half a voxel would put
    every centre on a rounding tie between two pool voxels, which the JAX
    package itself settles differently compiled and eager."""
    kw = dict(dims=(40, 30, 20), voxel_size=0.03, origin=(-0.435, -0.345, 0.795), rgb_channels=True,
              feature_channels=4)
    jmap = jm.Mapper(jm.MapperConfig(**kw), storage="sparse")
    tmap = ct.Mapper(tm.MapperConfig(**kw), storage="sparse", device=DEV)
    (ja, ta), (jb_, tb_) = _rig(0)
    jmap.integrate(ja)
    tmap.integrate(ta)
    jmap.integrate_set([ja, jb_])
    tmap.integrate_set([ta, tb_])
    _assert_same(jmap._sparse.grid, tmap._sparse.grid)
    for k in ("tsdf", "weight", "rgb"):
        np.testing.assert_allclose(getattr(tmap.grid, k).numpy(), np.asarray(getattr(jmap.grid, k)),
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(tmap.compute_esdf().numpy(), np.asarray(jmap.compute_esdf()), atol=ATOL)
    jmap.decay(0.5)
    tmap.decay(0.5)
    _assert_same(jmap._sparse.grid, tmap._sparse.grid)
    assert tmap.stats() == jmap.stats()
    with pytest.raises(TypeError, match="CameraObservation"):
        tmap.integrate(tty.LidarObservation(torch.zeros(4, 3), ta.pose))
    with pytest.raises(TypeError, match="dense grid"):
        tmap.stamp(None)
    with pytest.raises(AttributeError):
        tmap.grid = tmap.grid
