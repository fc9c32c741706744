"""Parity of the port's matching ops and of K2's plain twin with the reference.

Tolerances and their reasons:
- ``hamming_matrix``, ``match_ratio``, ``match_windowed``, ``match_stereo``
  and ``scatter_matches``: exactly equal (integer distances, the same packed
  tie rules, the same float32 gate arithmetic);
- K2's twin against the reference Pallas kernel run with interpret=True:
  ``idx`` and ``col_best`` exactly equal, ``best``/``second`` equal wherever
  the reference's value is below 512 (its sentinel is 1e6, the port's 512);
- ``refine_disparity_subpixel``: atol 1e-4 px (window means are summed in
  another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitslam_tpu.ops import matching as jm
from fitslam_tpu.ops.pallas_matching import hamming_top2 as j_hamming_top2
from fitslam_tpu_torch.ops import matching as tm
from fitslam_tpu_torch.ops import orb as torb
from fitslam_tpu_torch.ops import pallas_matching as pm

# several pytest-xdist workers share the machine: torch's default of one
# intra-op thread per core would oversubscribe it
torch.set_num_threads(2)


def _problem(seed=0, na=192, nb=640):
    """Descriptors with planted near-duplicates and exact ties, positions with
    pairs on the window edge, levels, and validity masks."""
    rng = np.random.RandomState(seed)
    a = np.where(rng.rand(na, 256) < 0.5, 1.0, -1.0).astype(np.float32)
    b = np.where(rng.rand(nb, 256) < 0.5, 1.0, -1.0).astype(np.float32)
    xy_a = (rng.randint(0, 320, (na, 2)) + 0.5).astype(np.float32)
    xy_b = (rng.randint(0, 320, (nb, 2)) + 0.25).astype(np.float32)
    perm = rng.permutation(nb)
    for i in range(na // 2):
        j = perm[i]
        flip = rng.rand(256) < rng.uniform(0.0, 0.06)
        b[j] = np.where(flip, -a[i], a[i])
        xy_b[j, 0] = xy_a[i, 0] - rng.uniform(0.5, 40.0)
        xy_b[j, 1] = xy_a[i, 1] + rng.uniform(-2.5, 2.5)
    for i in range(na // 2, na // 2 + 16):          # two equal columns per row
        j1, j2 = perm[i], perm[i + 16]
        b[j1] = b[j2] = a[i]
        xy_b[j1] = xy_b[j2] = xy_a[i] + np.array([12.0, 0.0], np.float32)  # on the edge
    a[-8:] = a[:8]                                   # equal rows for column ties
    xy_a[-8:] = xy_a[:8]
    return dict(
        a=a, b=b, xy_a=xy_a, xy_b=xy_b,
        lvl_a=rng.randint(0, 4, na).astype(np.int32), lvl_b=rng.randint(0, 4, nb).astype(np.int32),
        va=rng.rand(na) < 0.9, vb=rng.rand(nb) < 0.9)


def _ref_dist(p):
    return jax.jit(jm.hamming_matrix)(jnp.asarray(p["a"], jnp.bfloat16), jnp.asarray(p["b"], jnp.bfloat16),
                                      jnp.asarray(p["va"]), jnp.asarray(p["vb"]))


def _t(x):
    return torch.tensor(np.asarray(x))


def _bits(x):
    return torb.pack_descriptors(_t(x).bfloat16())


def _assert_matches_equal(got, ref):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.idx_b.numpy(), np.asarray(ref.idx_b))
    np.testing.assert_array_equal(got.distance.numpy(), np.asarray(ref.distance))


def test_hamming_matrix_exact():
    p = _problem()
    got = tm.hamming_matrix(_t(p["a"]).bfloat16(), _t(p["b"]).bfloat16(), _t(p["va"]), _t(p["vb"]))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(_ref_dist(p)))


@pytest.mark.parametrize("mutual", [True, False])
def test_match_ratio_exact(mutual):
    p = _problem(1)
    dist = _ref_dist(p)
    ref = jax.jit(lambda d: jm.match_ratio(d, 64, 0.8, mutual))(dist)
    got = tm.match_ratio(_t(dist), 64, 0.8, mutual)
    _assert_matches_equal(got, ref)
    assert np.asarray(ref.valid).sum() > 20


@pytest.mark.parametrize("radius", [12.0, 24.0, 96.0])
def test_match_windowed_exact(radius):
    p = _problem(2)
    ref = jax.jit(lambda d, xa, xb: jm.match_windowed(d, xa, xb, radius, 64, 0.8))(
        _ref_dist(p), p["xy_a"], p["xy_b"])
    got = tm.match_windowed(_bits(p["a"]), _t(p["va"]), _bits(p["b"]), _t(p["vb"]),
                            _t(p["xy_a"]), _t(p["xy_b"]), radius, 64, 0.8)
    _assert_matches_equal(got, ref)


def test_match_stereo_exact():
    p = _problem(3)
    max_disp = np.float32(0.2) * np.float32(200.0) / np.float32(0.3)
    ref_m, ref_d = jax.jit(lambda d: jm.match_stereo(
        d, p["xy_a"], p["xy_b"], p["lvl_a"], p["lvl_b"], jnp.float32(max_disp)))(_ref_dist(p))
    got_m, got_d = tm.match_stereo(_bits(p["a"]), _t(p["va"]), _bits(p["b"]), _t(p["vb"]),
                                   _t(p["xy_a"]), _t(p["xy_b"]), _t(p["lvl_a"]), _t(p["lvl_b"]),
                                   torch.tensor(max_disp))
    _assert_matches_equal(got_m, ref_m)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(ref_d))
    assert np.asarray(ref_m.valid).sum() > 20


@pytest.mark.parametrize("mode", ["none", "window", "stereo"])
def test_k2_twin_equals_reference_selection(mode):
    """The twin's top-2 feeds the same acceptance test as match_ratio: its
    (idx, best, second) reproduce the reference's packed-key top-2 exactly."""
    p = _problem(4)
    dist = np.asarray(_ref_dist(p)).astype(np.int64)
    xa, xb = p["xy_a"], p["xy_b"]
    if mode == "window":
        d2 = ((xa[:, None, :] - xb[None, :, :]) ** 2).sum(-1)
        dist = np.where(d2 <= np.float32(24.0 * 24.0), dist, jm.BIG)
        gate = torch.tensor([24.0 * 24.0, 0.0])
    elif mode == "stereo":
        dv = np.abs(xa[:, None, 1] - xb[None, :, 1])
        disp = xa[:, None, 0] - xb[None, :, 0]
        ok = ((dv <= 2.0) & (disp > np.float32(0.1)) & (disp < np.float32(266.0))
              & (np.abs(p["lvl_a"][:, None] - p["lvl_b"][None, :]) <= 1))
        dist = np.where(ok, dist, jm.BIG)
        gate = torch.tensor([2.0, 266.0])
    else:
        gate = None
    nb = dist.shape[1]
    packed = np.minimum(dist, 512) * nb + np.arange(nb)
    p1 = packed.min(1)
    second = np.where(np.arange(nb)[None] == (p1 % nb)[:, None], 512 * nb, packed).min(1) // nb
    col_best = np.argmin(np.minimum(dist, 512), axis=0)
    mode_id = {"none": pm.GATE_NONE, "window": pm.GATE_WINDOW, "stereo": pm.GATE_STEREO}[mode]
    got = pm.hamming_top2(_bits(p["a"]), _t(p["va"]), _bits(p["b"]), _t(p["vb"]), mode_id,
                          xy_a=_t(xa), xy_b=_t(xb), level_a=_t(p["lvl_a"]),
                          level_b=_t(p["lvl_b"]), gate=gate)
    np.testing.assert_array_equal(got.idx.numpy(), p1 % nb)
    np.testing.assert_array_equal(got.best.numpy(), p1 // nb)
    np.testing.assert_array_equal(got.second.numpy(), second)
    np.testing.assert_array_equal(got.col_best.numpy(), col_best)


def test_k2_twin_equals_pallas_interpret():
    p = _problem(5, na=128, nb=512)
    ref = jax.tree.map(np.asarray, j_hamming_top2(
        jnp.asarray(p["a"], jnp.bfloat16), jnp.asarray(p["va"]),
        jnp.asarray(p["b"], jnp.bfloat16), jnp.asarray(p["vb"]), block=128, interpret=True))
    got = pm.hamming_top2(_bits(p["a"]), _t(p["va"]), _bits(p["b"]), _t(p["vb"]))
    np.testing.assert_array_equal(got.idx.numpy(), ref[0])
    np.testing.assert_array_equal(got.col_best.numpy(), ref[3])
    for g, r in ((got.best, ref[1]), (got.second, ref[2])):
        live = r < 512
        assert live.sum() > 50
        np.testing.assert_array_equal(g.numpy()[live], r[live].astype(np.int32))
        assert np.all(g.numpy()[~live] == 512)


@pytest.fixture(scope="module")
def top2_chunk_problem():
    """The interpret-mode reference problem, and the reference kernel's
    outputs on it (no gate: the Pallas kernel has none)."""
    p = _problem(5, na=128, nb=512)
    ref = jax.tree.map(np.asarray, j_hamming_top2(
        jnp.asarray(p["a"], jnp.bfloat16), jnp.asarray(p["va"]),
        jnp.asarray(p["b"], jnp.bfloat16), jnp.asarray(p["vb"]), block=128, interpret=True))
    return p, ref


@pytest.mark.parametrize("chunk", [37, 96, 200])
@pytest.mark.parametrize("mode", [pm.GATE_NONE, pm.GATE_WINDOW, pm.GATE_STEREO])
def test_k2_twin_column_chunks_merge_exactly(top2_chunk_problem, mode, chunk):
    """The kernel's split of the columns over blocks, mirrored by the twin's
    ``col_chunk``: chunk sizes that do not divide Nb, with the problem's
    planted row ties (equal columns) and column ties (equal rows), give the
    unchunked twin's outputs exactly, and the reference kernel's in
    interpret mode where it applies (no gate)."""
    p, ref = top2_chunk_problem
    gate = {pm.GATE_NONE: None, pm.GATE_WINDOW: torch.tensor([12.0 * 12.0, 0.0]),
            pm.GATE_STEREO: torch.tensor([2.0, 266.0])}[mode]
    args = (_bits(p["a"]), _t(p["va"]), _bits(p["b"]), _t(p["vb"]), mode,
            _t(p["xy_a"]), _t(p["xy_b"]), _t(p["lvl_a"]), _t(p["lvl_b"]), gate)
    whole = pm.hamming_top2_plain(*args)
    got = pm.hamming_top2_plain(*args, col_chunk=chunk)
    for f in pm.Top2._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(whole, f).numpy(), f)
    assert int((whole.best < 64).sum()) > 10
    if mode == pm.GATE_NONE:
        np.testing.assert_array_equal(got.idx.numpy(), ref[0])
        np.testing.assert_array_equal(got.col_best.numpy(), ref[3])
        for g, r in ((got.best, ref[1]), (got.second, ref[2])):
            live = r < 512
            np.testing.assert_array_equal(g.numpy()[live], r[live].astype(np.int32))
            assert np.all(g.numpy()[~live] == 512)


def test_k2_plan_covers_the_columns():
    """The column split of the tensor-core designs: whole 8-column tiles per
    warp, every column in exactly one split, about four blocks per SM by
    default."""
    for na, nb in ((1024, 8192), (1024, 1024), (1, 1), (37, 513), (1000, 8000), (64, 33)):
        for blocks_per_sm in (1, 2, 4, 8):
            plan = pm.top2_plan(na, nb, 132, blocks_per_sm)
            assert plan.cols_per_block % 32 == 0
            assert (plan.cols_per_block * plan.splits >= nb
                    > plan.cols_per_block * (plan.splits - 1))
    assert pm.top2_plan(1024, 8192, 132) == pm.Top2Plan(256, 32)
    assert pm.top2_plan(1024, 8192, 132, 8) == pm.Top2Plan(128, 64)


def test_k2_wrapper_checks_and_uses_twin_on_cpu():
    p = _problem(6, na=64, nb=128)
    before = pm.hamming_top2.launches
    pm.hamming_top2(_bits(p["a"]), _t(p["va"]), _bits(p["b"]), _t(p["vb"]))
    assert pm.hamming_top2.launches == before
    with pytest.raises(ValueError):   # window gate without coordinates
        pm.hamming_top2(_bits(p["a"]), _t(p["va"]), _bits(p["b"]), _t(p["vb"]), pm.GATE_WINDOW)
    with pytest.raises(ValueError):   # unpacked descriptors
        pm.hamming_top2(_t(p["a"]), _t(p["va"]), _t(p["b"]), _t(p["vb"]))


def test_refine_disparity_subpixel():
    rng = np.random.RandomState(7)
    img_l = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    shift = 6.4
    xs = np.arange(160, dtype=np.float32)
    img_r = np.stack([np.interp(xs + shift, xs, row) for row in img_l]).astype(np.float32)
    xy = np.stack([rng.uniform(0, 160, 200), rng.uniform(0, 120, 200)], -1).astype(np.float32)
    x_r = (xy[:, 0] - shift + rng.uniform(-1, 1, 200)).astype(np.float32)
    valid = rng.rand(200) < 0.9
    ref_d, ref_ok = jax.jit(jm.refine_disparity_subpixel)(img_l, img_r, xy, x_r, valid)
    got_d, got_ok = tm.refine_disparity_subpixel(_t(img_l), _t(img_r), _t(xy), _t(x_r), _t(valid))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), atol=1e-4)


def test_scatter_matches_exact():
    rng = np.random.RandomState(8)
    idx = rng.randint(0, 50, 120).astype(np.int32)
    valid = rng.rand(120) < 0.7
    dist = rng.randint(0, 64, 120).astype(np.int32)
    ref = jm.scatter_matches(jm.Matches(jnp.asarray(idx), jnp.asarray(dist), jnp.asarray(valid)), 64)
    got = tm.scatter_matches(tm.Matches(_t(idx), _t(dist), _t(valid)), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
