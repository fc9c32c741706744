"""The port's navigation layer against the reference on the CPU: K3's plain
twin, the wavefront potential and its descent, the costmap layers and the
lethal-marker overlay, and the raycasts the exploration costs use.

Tolerances: the sweeps, the costmaps and every grid of costs or cells are
exact (min-plus arithmetic, integer costs, the same float32 operations in
the same order); world coordinates of the descent path are exact (cell
centres); raycast headings and information are exact (angles from one
table, integer counts), unknown fractions within 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitslam_tpu.models import nav as jnav
from fitslam_tpu.models import sim_robot as jsim
from fitslam_tpu.ops import grid as jgrid
from fitslam_tpu.ops import pallas_grid as jpg
from fitslam_tpu.ops import raycast as jray
from fitslam_tpu.utils.config import FitSlamConfig as JConfig
from fitslam_tpu_torch.models import nav as tnav
from fitslam_tpu_torch.models import sim_robot as tsim
from fitslam_tpu_torch.ops import grid as tgrid
from fitslam_tpu_torch.ops import pallas_grid as tpg
from fitslam_tpu_torch.ops import raycast as tray

# several pytest-xdist workers share the machine: torch's default of one
# intra-op thread per core would oversubscribe it
torch.set_num_threads(2)

BIG = 1e9


def _spec(G):
    return (jgrid.GridSpec2D(G, 0.25, -G * 0.125, -G * 0.125),
            tgrid.GridSpec2D(G, 0.25, -G * 0.125, -G * 0.125))


def _explored(G, seed, frac=0.6):
    """A rooms world with part of it still unknown, and a few free costs."""
    js, _ = _spec(G)
    gt = jsim.make_rooms_world(js, seed=seed)
    rng = np.random.RandomState(seed)
    occ = gt.copy()
    occ[rng.rand(G, G) > frac] = jgrid.UNKNOWN
    occ[int(G * 0.6):, :] = jgrid.UNKNOWN
    free = occ == 0
    occ[free & (rng.rand(G, G) < 0.1)] = rng.randint(1, 200)
    return occ


def _sweep_problem(G, seed):
    rng = np.random.RandomState(seed)
    step = (rng.rand(G, G) * 0.3 + 0.25).astype(np.float32)
    passable = rng.rand(G, G) < 0.9
    pot0 = np.full((G, G), BIG, np.float32)
    pot0[rng.randint(G), rng.randint(G)] = 0.0
    return pot0, step, passable


@pytest.mark.parametrize("G,iters", [(32, 64), (32, 128), (64, 64), (64, 128)])
def test_k3_twin_equals_reference_kernel_and_xla_loop(G, iters):
    pot0, step, passable = _sweep_problem(G, G + iters)
    ref_kernel = np.asarray(jpg.wavefront_sweeps(jnp.asarray(pot0), jnp.asarray(step),
                                                 jnp.asarray(passable), iters, interpret=True))
    got = tpg.wavefront_sweeps(torch.tensor(pot0), torch.tensor(step),
                               torch.tensor(passable), iters).numpy()
    np.testing.assert_array_equal(got, ref_kernel)
    # and through the reference's own XLA roll loop (wavefront_potential on
    # the CPU): a goal on a rooms world with free, costed and unknown cells
    js, ts = _spec(G)
    occ = _explored(G, G)
    goal = np.array([-1.3, 0.6], np.float32)
    ref = np.asarray(jnav.wavefront_potential(js, jnp.asarray(occ), jnp.asarray(goal), iters=iters))
    port = tnav.wavefront_potential(ts, torch.tensor(occ), torch.tensor(goal), iters=iters)
    np.testing.assert_array_equal(port.numpy(), ref)
    assert (ref < BIG).sum() > G          # the wavefront really spread


def test_k3_twin_edges_are_big_not_wrapped():
    G = 16
    pot0 = np.full((G, G), BIG, np.float32)
    pot0[0, 0] = 0.0
    step = np.ones((G, G), np.float32)
    got = tpg.wavefront_sweeps(torch.tensor(pot0), torch.tensor(step),
                               torch.ones(G, G, dtype=torch.bool), 64).numpy()
    yy, xx = np.mgrid[:G, :G]
    np.testing.assert_array_equal(got, (yy + xx).astype(np.float32))
    assert tpg.wavefront_sweeps(torch.tensor(pot0), torch.tensor(step),
                                torch.ones(G, G, dtype=torch.bool), 0).equal(torch.tensor(pot0))


@pytest.mark.parametrize("H,W", [(64, 64), (320, 320), (512, 512), (513, 513), (64, 192),
                                 (333, 250), (1, 1), (1, 300), (90, 90), (100, 37), (1, 4096)])
def test_k3_size_rule_covers_the_grid(H, W):
    """K3's size rule: a resident plan covers the grid with one cluster of at
    most 16 blocks of at most 512 threads; the main path's grids (64, 320,
    512) are resident, and a grid past the rule (513) is tiled."""
    plan = tpg.sweep_plan(H, W)
    if plan.design == "tiled":
        assert (H, W) in ((513, 513), (1, 4096))
        return
    assert (H, W) not in ((513, 513), (1, 4096))
    assert plan.rows_per_thread in (4, 8)
    assert plan.threads_x * plan.threads_y <= tpg.RESIDENT_MAX_THREADS
    assert 1 <= plan.blocks <= tpg.RESIDENT_MAX_BLOCKS
    assert 4 * plan.threads_x >= W > 4 * (plan.threads_x - 1)
    band = plan.rows_per_thread * plan.threads_y
    assert plan.blocks * band >= H > (plan.blocks - 1) * band
    assert plan.blocks == min(H, tpg.RESIDENT_MAX_BLOCKS) or band > -(-H // 16)


@pytest.mark.parametrize("group", [2, 4, 8])
@pytest.mark.parametrize("H,W", [(64, 64), (320, 320), (512, 512), (333, 250), (90, 90),
                                 (100, 37), (1, 300)])
def test_k3_grouped_plan_covers_the_grid(H, W, group):
    """A resident plan whose bands exchange rows every ``group`` sweeps:
    each band's own rows (its rows less ``group`` halo rows on either side)
    cover the grid with at least ``group`` rows a band, in one cluster of at
    most 16 blocks of at most 512 threads; a grid whose bands cannot hold
    the halo rows (512) or that is a single band (one row) has no such plan."""
    if (H, W) in ((512, 512), (1, 300)):
        with pytest.raises(ValueError):
            tpg.sweep_plan(H, W, group)
        return
    plan = tpg.sweep_plan(H, W, group)
    assert plan.design == "resident" and plan.group == group
    assert plan.threads_x * plan.threads_y <= tpg.RESIDENT_MAX_THREADS
    assert 1 < plan.blocks <= tpg.RESIDENT_MAX_BLOCKS
    assert 4 * plan.threads_x >= W > 4 * (plan.threads_x - 1)
    own = plan.rows_per_thread * plan.threads_y - 2 * group
    assert own >= group
    assert plan.blocks * own >= H > (plan.blocks - 1) * own


def test_k3_wrapper_rejects_bad_inputs():
    z = torch.zeros(8, 8)
    with pytest.raises(ValueError):
        tpg.wavefront_sweeps(z, z.double(), z > 0, 4)
    with pytest.raises(ValueError):
        tpg.wavefront_sweeps(z, torch.zeros(8, 9), z > 0, 4)
    with pytest.raises(ValueError):
        tpg.wavefront_sweeps(z.to("meta"), z.to("meta"), (z > 0).to("meta"), 4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_descend_potential_equals_reference(seed):
    G = 64
    js, ts = _spec(G)
    occ = _explored(G, seed, frac=0.8)
    rng = np.random.RandomState(seed)
    goal = rng.uniform(-7, 7, 2).astype(np.float32)
    start = rng.uniform(-7, 7, 2).astype(np.float32)
    pot_j = jnav.wavefront_potential(js, jnp.asarray(occ), jnp.asarray(goal), iters=192)
    pot_t = tnav.wavefront_potential(ts, torch.tensor(occ), torch.tensor(goal), iters=192)
    np.testing.assert_array_equal(pot_t.numpy(), np.asarray(pot_j))
    for max_steps in (256, 40):
        xy_j, ok_j = jnav.descend_potential(js, pot_j, jnp.asarray(start), max_steps=max_steps)
        xy_t, ok_t = tnav.descend_potential(ts, pot_t, torch.tensor(start), max_steps=max_steps)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        np.testing.assert_allclose(xy_t.numpy(), np.asarray(xy_j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_inflation_and_costmaps_equal_reference(seed):
    G = 64
    js, ts = _spec(G)
    occ = _explored(G, seed)
    for radius, scale, inscribed in ((0.6, 0.6, 0.1), (5.0, 0.6, 0.05), (0.3, 0.6, 0.05)):
        ref = np.asarray(jgrid.inflate_grid(jnp.asarray(occ), 0.25, inflation_radius_m=radius,
                                            cost_scaling_factor=scale,
                                            inscribed_radius_m=inscribed))
        got = tgrid.inflate_grid(torch.tensor(occ), 0.25, inflation_radius_m=radius,
                                 cost_scaling_factor=scale, inscribed_radius_m=inscribed)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), ref)
    cfg = JConfig()
    overlay = np.zeros((G, G), bool)
    overlay[10:14, 20:26] = True
    robot = np.array([-3.0, -2.0], np.float32)
    for layer in (cfg.costmaps.global_map, cfg.costmaps.local,
                  dataclasses.replace(cfg.costmaps.local, rolling=False, resample=2),
                  dataclasses.replace(cfg.costmaps.local, rolling=False, resample=-2)):
        jcm = jnav.Costmap(js, layer, lambda: jnp.asarray(occ), lambda: jnp.asarray(overlay))
        src, ov = torch.tensor(occ), torch.tensor(overlay)
        tcm = tnav.Costmap(ts, layer, lambda: src, lambda: ov)
        (rj, sj), (rt, st) = jcm.grid(robot), tcm.grid(robot)
        assert tuple(st) == tuple(sj)
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
        full_j, _ = jcm.grid_full_np()
        full_t, _ = tcm.grid_full_np()
        np.testing.assert_array_equal(full_t, full_j)
        tcm.grid_full_np()
        assert tcm.host_syncs == 1           # one read per map update


def test_overlays_and_footprint_equal_reference():
    G = 64
    js, ts = _spec(G)
    occ = _explored(G, 5)
    apex = np.array([1.2, -0.7], np.float32)
    ov0 = np.zeros((G, G), bool)
    wedge_j = jnav.mark_lethal_wedge(js, jnp.asarray(ov0), jnp.asarray(apex), jnp.float32(0.8))
    wedge_t = tnav.mark_lethal_wedge(ts, torch.tensor(ov0), torch.tensor(apex), 0.8)
    np.testing.assert_array_equal(wedge_t.numpy(), np.asarray(wedge_j))
    circles = np.full((8, 3), 1e9, np.float32)
    circles[:, 2] = 0.0
    circles[:3] = [[0.0, 0.0, 1.2], [-4.0, 3.0, 0.5], [6.0, -6.5, 2.0]]
    discs_j = jnav.mark_lethal_discs(js, jnp.asarray(ov0), jnp.asarray(circles))
    discs_t = tnav.mark_lethal_discs(ts, torch.tensor(ov0), torch.tensor(circles))
    np.testing.assert_array_equal(discs_t.numpy(), np.asarray(discs_j))
    np.testing.assert_array_equal(
        tnav.apply_overlay(torch.tensor(occ), discs_t).numpy(),
        np.asarray(jnav.apply_overlay(jnp.asarray(occ), discs_j)))
    age0 = np.full((G, G), -1, np.int32)
    age_j = jnav.mark_wedge_age(js, jnp.asarray(age0), jnp.asarray(apex), jnp.float32(-2.0),
                                jnp.int32(7))
    age_t = tnav.mark_wedge_age(ts, torch.tensor(age0), torch.tensor(apex), -2.0, 7)
    np.testing.assert_array_equal(age_t.numpy(), np.asarray(age_j))
    for tick, ttl in ((8, 600), (700, 600), (700, 0)):
        np.testing.assert_array_equal(
            tnav.age_overlay_active(age_t, tick, ttl).numpy(),
            np.asarray(jnav.age_overlay_active(age_j, jnp.int32(tick), jnp.int32(ttl))))
    cleared_j = jnav.clear_age_disc(js, age_j, jnp.asarray(apex), jnp.float32(1.5))
    cleared_t = tnav.clear_age_disc(ts, age_t, torch.tensor(apex), 1.5)
    np.testing.assert_array_equal(cleared_t.numpy(), np.asarray(cleared_j))
    robot = np.array([-2.1, 3.3], np.float32)
    np.testing.assert_array_equal(
        tnav.clear_robot_footprint(ts, torch.tensor(occ), torch.tensor(robot)).numpy(),
        np.asarray(jnav.clear_robot_footprint(js, jnp.asarray(occ), jnp.asarray(robot))))


def test_pure_pursuit_equals_reference():
    path = np.array([[0.0, 0.0], [0.5, 0.2], [1.0, 0.8], [1.5, 1.5], [2.0, 2.5]])
    for pose, yaw in (((0.1, 0.0), 0.3), ((0.1, 0.0), 2.5), ((1.9, 2.4), 1.0), ((0.9, 0.7), 0.9)):
        assert tnav.PurePursuit().command(pose, yaw, path) == jnav.PurePursuit().command(pose, yaw, path)
    assert tnav.PurePursuit().command((0, 0), 0.0, np.zeros((0, 2))) == (0.0, 0.0, True)


@pytest.mark.parametrize("seed", [0, 1])
def test_raycasts_equal_reference(seed):
    G = 64
    js, ts = _spec(G)
    occ = _explored(G, seed)
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-8.5, 8.5, (40, 2)).astype(np.float32)
    valid = rng.rand(40) < 0.8
    hj, ij = jray.arrival_information(js, jnp.asarray(occ), jnp.asarray(pts), jnp.asarray(valid))
    ht, it = tray.arrival_information(ts, torch.tensor(occ), torch.tensor(pts), torch.tensor(valid))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert np.asarray(ij).max() > 0
    a = rng.uniform(-8, 8, (200, 2)).astype(np.float32)
    b = rng.uniform(-8, 8, (200, 2)).astype(np.float32)
    hit_j, unk_j = jray.segment_clearance(js, jnp.asarray(occ), jnp.asarray(a), jnp.asarray(b))
    hit_t, unk_t = tray.segment_clearance(ts, torch.tensor(occ), torch.tensor(a), torch.tensor(b))
    np.testing.assert_array_equal(hit_t.numpy(), np.asarray(hit_j))
    np.testing.assert_allclose(unk_t.numpy(), np.asarray(unk_j), rtol=0, atol=1e-6)
    ang = rng.uniform(-np.pi, np.pi, 12)
    dirs = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    for origin in (a[0], a[1], np.array([0.0, 0.0], np.float32)):
        fj = jray.free_distance(js, jnp.asarray(occ), jnp.asarray(origin), jnp.asarray(dirs))
        ft = tray.free_distance(ts, torch.tensor(occ), torch.tensor(origin), torch.tensor(dirs))
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-6)


def test_reveal_sensor_equals_reference():
    G = 64
    js, ts = _spec(G)
    gt = jsim.make_rooms_world(js, seed=1)
    np.testing.assert_array_equal(tsim.make_rooms_world(ts, seed=1), gt)
    ej = jnp.full((G, G), jgrid.UNKNOWN, jnp.uint8)
    et = torch.full((G, G), tgrid.UNKNOWN, dtype=torch.uint8)
    robot = tsim.DiffDriveRobot(x=-5.0, y=-5.0)
    for v, w in ((0.8, 0.0), (0.8, 0.6), (0.5, -1.0), (1.0, 0.2)):
        for _ in range(6):
            robot.step(v, w, 0.15)
        xy = np.asarray(robot.xy, np.float32)
        ej = jsim.reveal_sensor(js, jnp.asarray(gt), ej, jnp.asarray(xy), range_m=3.0)
        et = tsim.reveal_sensor(ts, torch.tensor(gt), et, torch.tensor(xy), range_m=3.0)
        np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    assert (et.numpy() != tgrid.UNKNOWN).mean() > 0.05
    jr = jsim.DiffDriveRobot(x=-5.0, y=-5.0)
    for v, w in ((0.8, 0.0), (0.8, 0.6), (0.5, -1.0), (1.0, 0.2)):
        for _ in range(6):
            jr.step(v, w, 0.15)
    assert robot.trajectory == jr.trajectory
