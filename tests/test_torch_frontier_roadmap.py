"""The port's frontier search, roadmap and frontier costs against the
reference on the CPU, on partly explored rooms worlds.

Tolerances: frontier uid, size and valid exact, goal and centroid world
coordinates exact (cell centres); roadmap adjacency and every index exact,
distances within 1e-5 (float32 Bellman-Ford sums); costs within 1e-5 and
every selected index exact.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitslam_tpu.models import costs as jcx
from fitslam_tpu.models import roadmap as jrm
from fitslam_tpu.models import sim_robot as jsim
from fitslam_tpu.ops import frontier as jfx
from fitslam_tpu.ops import grid as jgrid
from fitslam_tpu.ops import lie as jlie
from fitslam_tpu_torch.models import costs as tcx
from fitslam_tpu_torch.models import roadmap as trm
from fitslam_tpu_torch.ops import frontier as tfx
from fitslam_tpu_torch.ops import grid as tgrid
from fitslam_tpu_torch.ops import lie as tlie
from fitslam_tpu_torch.utils import interop, prng

# several pytest-xdist workers share the machine: torch's default of one
# intra-op thread per core would oversubscribe it
torch.set_num_threads(2)

G = 64
JS = jgrid.GridSpec2D(G, 0.25, -8.0, -8.0)
TS = tgrid.GridSpec2D(G, 0.25, -8.0, -8.0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _explored(seed):
    """The rooms world revealed around a few rooms' worth of robot poses."""
    gt = jsim.make_rooms_world(JS, seed=1)
    explored = jnp.full((G, G), jgrid.UNKNOWN, jnp.uint8)
    rng = np.random.RandomState(seed)
    for _ in range(4 + seed):
        xy = rng.uniform(-6.5, 6.5, 2).astype(np.float32)
        explored = jsim.reveal_sensor(JS, jnp.asarray(gt), explored, jnp.asarray(xy), range_m=3.0)
    return np.asarray(explored), gt


def _assert_tree_equal(got, ref, atol=0.0):
    assert type(got).__name__ == type(ref).__name__
    for f in ref._fields:
        g, r = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
        assert g.dtype == r.dtype, (f, g.dtype, r.dtype)
        if atol and np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=f)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f)


@pytest.mark.parametrize("seed,radius,max_cluster", [(0, 6.0, 20), (1, 4.0, 5), (2, 12.0, 20)])
def test_extract_frontiers_equals_reference(seed, radius, max_cluster):
    occ, _ = _explored(seed)
    robot = np.array([-1.0, 0.5], np.float32)
    ref = _np(jfx.extract_frontiers(JS, jnp.asarray(occ), jnp.asarray(robot),
                                    jnp.float32(radius), max_cells=1024, max_frontiers=64,
                                    max_cluster_size=max_cluster))
    got = interop.to_numpy(tfx.extract_frontiers(TS, torch.tensor(occ), torch.tensor(robot),
                                                 radius, max_cells=1024, max_frontiers=64,
                                                 max_cluster_size=max_cluster))
    _assert_tree_equal(got, ref)
    assert ref.valid.sum() >= 2


def test_extract_frontiers_caps_and_boundary_equal_reference():
    occ, _ = _explored(3)
    # a cell list shorter than the mask, more clusters than slots, a boundary
    verts = np.array([[-7.0, -7.0], [5.0, -6.0], [6.0, 6.5], [-6.5, 4.0]], np.float32)
    bj = jfx.polygon_mask(JS, jnp.asarray(verts))
    bt = tfx.polygon_mask(TS, torch.tensor(verts))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    for boundary in (None, (bj, bt)):
        ref = _np(jfx.extract_frontiers(JS, jnp.asarray(occ), jnp.zeros(2), jnp.float32(20.0),
                                        max_cells=64, max_frontiers=8, max_cluster_size=3,
                                        boundary=None if boundary is None else boundary[0]))
        got = interop.to_numpy(tfx.extract_frontiers(
            TS, torch.tensor(occ), torch.zeros(2), 20.0, max_cells=64, max_frontiers=8,
            max_cluster_size=3, boundary=None if boundary is None else boundary[1]))
        _assert_tree_equal(got, ref)
    ref = _np(jfx.extract_frontiers_all_cells(JS, jnp.asarray(occ), max_cells=512, max_frontiers=32))
    got = interop.to_numpy(tfx.extract_frontiers_all_cells(TS, torch.tensor(occ), max_cells=512,
                                                           max_frontiers=32))
    _assert_tree_equal(got, ref)


def test_propagate_labels_equals_reference():
    rng = np.random.RandomState(4)
    mask = rng.rand(G, G) < 0.45
    for iters in (1, 8, 64):
        np.testing.assert_array_equal(
            tfx.propagate_labels(torch.tensor(mask), iters).numpy(),
            np.asarray(jfx.propagate_labels(jnp.asarray(mask), iters)))


def _roadmaps(seed, max_nodes=128):
    """The same roadmap built by both: batches of pose and frontier nodes,
    connected on an explored map."""
    occ, _ = _explored(seed)
    rng = np.random.RandomState(seed)
    rj = jrm.empty_roadmap(max_nodes, 16)
    rt = trm.empty_roadmap(max_nodes, 16, device="cpu")
    kj, kt = jlie.SE3.identity((1,)), tlie.SE3.identity((1,))
    for b in range(6):
        cand = rng.uniform(-7, 7, (24, 2)).astype(np.float32)
        valid = rng.rand(24) < 0.9
        front = np.full(24, b % 2 == 1)
        rj = jrm.add_nodes(rj, jnp.asarray(cand), jnp.asarray(valid), jnp.asarray(front),
                           kj, jnp.int32(1), 0.45)
        rt = trm.add_nodes(rt, torch.tensor(cand), torch.tensor(valid), torch.tensor(front),
                           kt, 1, 0.45)
    rj = jrm.connect_edges(rj, JS, jnp.asarray(occ), 6.1, 0.3)
    rt = trm.connect_edges(rt, TS, torch.tensor(occ), 6.1, 0.3)
    return occ, rj, rt


@pytest.mark.parametrize("seed", [0, 1])
def test_roadmap_build_and_paths_equal_reference(seed):
    occ, rj, rt = _roadmaps(seed)
    _assert_tree_equal(interop.to_numpy(rt), _np(rj), atol=1e-5)
    assert int(rj.n_nodes) == 128 or int(rj.n_nodes) > 60
    assert (np.asarray(rj.adj) >= 0).sum() > 100
    # the roadmap carried across through interop rebuilds the same edges
    carried = interop.to_torch(_np(rj))
    np.testing.assert_array_equal(
        trm.connect_edges(carried, TS, torch.tensor(occ)).adj.numpy(), np.asarray(rj.adj))
    srcs = np.random.RandomState(seed).uniform(-6, 6, (6, 2)).astype(np.float32)
    dj, pj, sj = jrm.shortest_paths_multi(rj, jnp.asarray(srcs))
    dt, pt, st = trm.shortest_paths_multi(rt, torch.tensor(srcs))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-5)
    d1j, p1j, s1j = jrm.shortest_paths(rj, jnp.asarray(srcs[0]))
    d1t, p1t, s1t = trm.shortest_paths(rt, torch.tensor(srcs[0]))
    np.testing.assert_allclose(d1t.numpy(), np.asarray(d1j), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(p1t.numpy(), np.asarray(p1j))
    assert int(s1t) == int(s1j)
    goal = srcs[3]
    gj = int(jrm.nearest_node(rj, jnp.asarray(goal)))
    assert int(trm.nearest_node(rt, torch.tensor(goal))) == gj
    path = trm.extract_path(rt, p1t.numpy(), int(s1t), gj)
    assert path == jrm.extract_path(rj, np.asarray(p1j), int(s1j), gj)
    # reanchoring through an identity keyframe keeps every node in place
    re_t = trm.reanchor_nodes(rt, tlie.SE3.identity((1,)))
    np.testing.assert_allclose(re_t.xy.numpy(), np.asarray(jrm.reanchor_nodes(
        rj, jlie.SE3.identity((1,))).xy), rtol=0, atol=1e-6)


def test_refine_path_los_equals_reference():
    occ, _ = _explored(1)
    rng = np.random.RandomState(7)
    for n in (2, 5, 17, 32):
        wp = np.zeros((32, 2), np.float32)
        wp[:n] = np.cumsum(rng.uniform(-1.0, 1.0, (n, 2)), axis=0).astype(np.float32)
        wv = np.arange(32) < n
        np.testing.assert_array_equal(
            trm.refine_path_los(TS, torch.tensor(occ), torch.tensor(wp), torch.tensor(wv)).numpy(),
            np.asarray(jrm.refine_path_los(JS, jnp.asarray(occ), jnp.asarray(wp), jnp.asarray(wv))))


@pytest.mark.parametrize("seed,methods", [
    (0, ("RoadmapPlannerDistance", "ArrivalInformation")),
    (1, ("RoadmapPlannerDistance", "ArrivalInformation")),
    (2, ("ClosestFrontier",)),
])
def test_costs_and_tsp_equal_reference(seed, methods):
    from fitslam_tpu.models import nav as jnav

    from fitslam_tpu_torch.models import nav as tnav

    occ, rj, rt = _roadmaps(seed)
    robot = np.array([-1.0, 0.5], np.float32)
    frj = jfx.extract_frontiers(JS, jnp.asarray(occ), jnp.asarray(robot), jnp.float32(12.0),
                                max_cells=1024, max_frontiers=64)
    frt = interop.to_torch(_np(frj))
    dist_j, _, _ = jrm.shortest_paths(rj, jnp.asarray(robot))
    dist_t, _, _ = trm.shortest_paths(rt, torch.tensor(robot))
    circles = np.full((64, 3), 1e9, np.float32)
    circles[:, 2] = 0.0
    circles[0] = [float(frj.goal_xy[0, 0]), float(frj.goal_xy[0, 1]), 1.2]
    bl_j = jcx.blacklist_mask(frj.goal_xy, jnp.asarray(circles))
    bl_t = tcx.blacklist_mask(frt.goal_xy, torch.tensor(circles))
    np.testing.assert_array_equal(bl_t.numpy(), np.asarray(bl_j))
    pot_j = jnav.wavefront_potential(JS, jnp.asarray(occ), jnp.asarray(robot), iters=192)
    pot_t = tnav.wavefront_potential(TS, torch.tensor(occ), torch.tensor(robot), iters=192)
    cj = jcx.assign_costs(JS, jnp.asarray(occ), frj, rj.xy, rj.valid, dist_j, bl_j,
                          grid_pot=pot_j, methods=methods, robot_xy=jnp.asarray(robot))
    ct = tcx.assign_costs(TS, torch.tensor(occ), frt, rt.xy, rt.valid, dist_t, bl_t,
                          grid_pot=pot_t, methods=methods, robot_xy=torch.tensor(robot))
    _assert_tree_equal(interop.to_numpy(ct), _np(cj), atol=1e-5)
    assert np.asarray(cj.achievable).sum() > 1

    sel_j, sv_j, g_j = jcx.select_locals(cj, frj, bl_j, 12.0)
    sel_t, sv_t, g_t = tcx.select_locals(ct, frt, bl_t, 12.0)
    for a, b in ((sel_t, sel_j), (sv_t, sv_j), (g_t, g_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    srcs_j = jcx.make_bf_sources(jnp.asarray(robot), frj.goal_xy, sel_j)
    srcs_t = tcx.make_bf_sources(torch.tensor(robot), frt.goal_xy, sel_t)
    np.testing.assert_array_equal(srcs_t.numpy(), np.asarray(srcs_j))
    dj, _, _ = jrm.shortest_paths_multi(rj, srcs_j)
    dt, _, _ = trm.shortest_paths_multi(rt, srcs_t)
    gn_j = jcx.global_node(cj.node_idx, g_j)
    gn_t = tcx.global_node(ct.node_idx, g_t)
    assert int(gn_t) == int(gn_j)
    plan_j = jcx.optimize_full_path(cj, frj, bl_j, dj, sel_j, sv_j, gn_j)
    plan_t = tcx.optimize_full_path(ct, frt, bl_t, dt, sel_t, sv_t, gn_t)
    _assert_tree_equal(interop.to_numpy(plan_t), _np(plan_j), atol=1e-5)
    hj, ij = jcx.finalize_goal(plan_j.has_goal, plan_j.goal_idx, g_j)
    ht, it = tcx.finalize_goal(plan_t.has_goal, plan_t.goal_idx, g_t)
    assert bool(ht) == bool(hj) and int(it) == int(ij)
    np.testing.assert_array_equal(tcx.snap_to_nodes(frt.goal_xy, rt.xy, rt.valid).numpy(),
                                  np.asarray(jcx.snap_to_nodes(frj.goal_xy, rj.xy, rj.valid)))


def test_tsp_with_a_closest_global_equals_reference():
    """A hand-made cost record: two locals, one global, unreachable legs."""
    rng = np.random.RandomState(11)
    F, N = 16, 32
    costs = jcx.FrontierCosts(
        arrival_info=jnp.asarray(rng.uniform(0, 40, F).astype(np.float32)),
        best_heading=jnp.zeros(F),
        path_length=jnp.asarray(np.r_[[3.0, 5.0, 20.0], np.full(F - 3, 1e9)].astype(np.float32)),
        utility=jnp.zeros(F),
        weighted_cost=jnp.asarray(np.r_[[2.0, 1.5, 3.0], np.full(F - 3, 1e9)].astype(np.float32)),
        achievable=jnp.asarray(np.arange(F) < 3),
        node_idx=jnp.asarray(rng.randint(0, N, F).astype(np.int32)),
        path_fi=jnp.zeros(F))
    fr = jfx.Frontiers(uid=jnp.zeros(F, jnp.int32), goal_xy=jnp.zeros((F, 2)),
                       centroid_xy=jnp.zeros((F, 2)), size=jnp.ones(F, jnp.int32),
                       valid=jnp.asarray(np.arange(F) < 3))
    bl = jnp.zeros(F, bool)
    pair = rng.uniform(0, 10, (6, N)).astype(np.float32)
    pair[2, 5] = 1e9
    sel_j, sv_j, g_j = jcx.select_locals(costs, fr, bl, 12.0)
    ct, frt = interop.to_torch(_np(costs)), interop.to_torch(_np(fr))
    sel_t, sv_t, g_t = tcx.select_locals(ct, frt, torch.tensor(np.asarray(bl)), 12.0)
    assert int(g_t) == int(g_j) == 2
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    gn = jcx.global_node(costs.node_idx, g_j)
    plan_j = jcx.optimize_full_path(costs, fr, bl, jnp.asarray(pair), sel_j, sv_j, gn)
    plan_t = tcx.optimize_full_path(ct, frt, torch.tensor(np.asarray(bl)), torch.tensor(pair),
                                    sel_t, sv_t, tcx.global_node(ct.node_idx, g_t))
    _assert_tree_equal(interop.to_numpy(plan_t), _np(plan_j), atol=1e-5)


RANDOM_COSTS_DRAWS = Path(__file__).resolve().parent / "data" / "random_costs_draws.npz"


@pytest.mark.parametrize("F", [1, 2, 7, 64, 100, 256])
def test_prng_uniform_bit_equal_to_jax_random(F):
    """utils/prng.py's Threefry draw equals jax.random's bit for bit: the
    key of PRNGKey(t), the raw bits and the float32 uniforms in [1, 100)."""
    for t in (0, 1, 2, 17, 149, 150, 65535, 2 ** 31 - 1):
        key = jax.random.PRNGKey(t)
        np.testing.assert_array_equal(prng.prng_key(t), np.asarray(jax.random.key_data(key)))
        np.testing.assert_array_equal(prng.random_bits(prng.prng_key(t), (F,)),
                                      np.asarray(jax.random.bits(key, (F,), jnp.uint32)))
        ref = np.asarray(jax.random.uniform(key, (F,), minval=1.0, maxval=100.0))
        got = prng.uniform(prng.prng_key(t), (F,), 1.0, 100.0)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (2, F)))
    np.testing.assert_array_equal(prng.uniform(prng.prng_key(3), (2, F)), ref)


def test_random_costs_draws_file_equals_jax():
    """tests/data/random_costs_draws.npz: the reference's RandomCosts draws for
    ticks 0-150 at the ablation's max_frontiers = 64, regenerated with JAX."""
    data = np.load(RANDOM_COSTS_DRAWS)
    ticks, draws = data["ticks"], data["draws"]
    np.testing.assert_array_equal(ticks, np.arange(151))
    ref = np.stack([np.asarray(jax.random.uniform(jax.random.PRNGKey(int(t)), (64,),
                                                  minval=1.0, maxval=100.0)) for t in ticks])
    np.testing.assert_array_equal(draws.view(np.uint32), ref.view(np.uint32))
    port = np.stack([prng.uniform(prng.prng_key(int(t)), (64,), 1.0, 100.0) for t in ticks])
    np.testing.assert_array_equal(port.view(np.uint32), draws.view(np.uint32))


def test_random_costs_raise_not_implemented():
    """RandomCosts (ROADMAP F11, closed): the port once raised here; now
    ``assign_costs(methods=("RandomCosts",))`` equals the reference's for the
    tick keys the exploration server passes and for the default key."""
    occ, rj, rt = _roadmaps(0, max_nodes=32)
    robot = np.array([-1.0, 0.5], np.float32)
    frj = jfx.extract_frontiers(JS, jnp.asarray(occ), jnp.asarray(robot), jnp.float32(12.0),
                                max_cells=1024, max_frontiers=16)
    frt = interop.to_torch(_np(frj))
    dist_j, _, _ = jrm.shortest_paths(rj, jnp.asarray(robot))
    dist_t, _, _ = trm.shortest_paths(rt, torch.tensor(robot))
    bl = np.zeros(16, bool)
    bl[1] = True
    for t in (None, 0, 1, 150):
        cj = jcx.assign_costs(JS, jnp.asarray(occ), frj, rj.xy, rj.valid, dist_j,
                              jnp.asarray(bl), methods=("RandomCosts",),
                              robot_xy=jnp.asarray(robot),
                              rng_key=None if t is None else jax.random.PRNGKey(t))
        ct = tcx.assign_costs(TS, torch.tensor(occ), frt, rt.xy, rt.valid, dist_t,
                              torch.tensor(bl), methods=("RandomCosts",),
                              robot_xy=torch.tensor(robot),
                              rng_key=None if t is None else prng.prng_key(t))
        _assert_tree_equal(interop.to_numpy(ct), _np(cj), atol=1e-5)
        np.testing.assert_array_equal(ct.weighted_cost.numpy(), np.asarray(cj.weighted_cost))
        np.testing.assert_array_equal(ct.utility.numpy(), np.asarray(cj.utility))
    assert np.asarray(cj.achievable).sum() > 1
