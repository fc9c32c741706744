"""The port's hand-written CUDA kernels against their plain PyTorch twins.

A CUDA kernel has no CPU or interpret mode, so these tests need the card:
they carry the ``gpu`` marker and skip without CUDA. On the card:

    python3 -m pytest -m gpu tests/test_torch_kernels_gpu.py

Tolerance: none. K1's gather is a copy (bit-equal); K1's fused describe sums
in the order its twin fixes (angle and descriptor bit-equal); K2's outputs
are integers (exactly equal); K3 is min and one float32 add per cell and
sweep, in the same Jacobi order as its twin (exactly equal).
"""


import numpy as np
import pytest
import torch

from fitslam_tpu_torch.models import nav, sim_robot
from fitslam_tpu_torch.ops import grid, orb
from fitslam_tpu_torch.ops import pallas_grid as pg
from fitslam_tpu_torch.ops import pallas_matching as pm
from fitslam_tpu_torch.ops import pallas_patches as pp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("hw,n", [((480, 640), 546), ((336, 448), 273),
                                  ((240, 320), 137), ((168, 224), 68)])
def test_k1_bit_equal_to_twin(cuda, hw, n):
    rng = np.random.RandomState(n)
    img = torch.tensor(rng.uniform(0, 255, hw).astype(np.float32), device=cuda)
    xy = np.stack([rng.randint(-30, hw[1] + 30, n), rng.randint(-30, hw[0] + 30, n)], -1)
    xy = torch.tensor(xy.astype(np.int32), device=cuda)
    before = pp.gather_patches.launches
    got = pp.gather_patches(img, xy, 40)
    assert pp.gather_patches.launches == before + 1
    assert torch.equal(got, pp.gather_patches_plain(img, xy, 40))


# ((H, W), keypoints) a level: the bench's 4 levels, the golden replay's 2,
# one keypoint, a level without keypoints, and a width that is not a multiple of 8
DESCRIBE_CASES = {
    "bench": (((480, 640), 546), ((336, 448), 273), ((240, 320), 137), ((168, 224), 68)),
    "golden": (((240, 320), 341), ((168, 224), 171)),
    "one keypoint": (((480, 640), 1),),
    "empty level": (((240, 320), 50), ((168, 224), 0), ((120, 160), 20)),
    "width 250": (((333, 250), 300), ((235, 177), 60), ((100, 37), 5)),
}


def _describe_inputs(cuda, levels, seed, border, integer):
    """Random grey-level images and keypoints inside the EDGE = 16 margin;
    with ``border``, the first keypoints of each level sit on the margin,
    on the image's edge and 30 pixels past it."""
    rng = np.random.RandomState(seed)
    imgs, xys = [], []
    for (h, w), n in levels:
        img = rng.uniform(0, 255, (h, w)).astype(np.float32)
        imgs.append(torch.tensor(np.floor(img) if integer else img, device=cuda))
        xy = np.stack([rng.randint(16, max(17, w - 16), n), rng.randint(16, max(17, h - 16), n)], -1)
        if border:
            edge = np.array([(16, 16), (w - 17, h - 17), (0, 0), (w - 1, h - 1), (-30, h // 2),
                             (w + 30, h // 2), (w // 2, -30), (w // 2, h + 30)])[:n]
            xy[:len(edge)] = edge
        xys.append(xy.reshape(-1, 2))
    return imgs, torch.tensor(np.concatenate(xys).astype(np.int32), device=cuda)


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("border", [False, True])
@pytest.mark.parametrize("case", sorted(DESCRIBE_CASES))
def test_k1_describe_bit_equal_to_twin(cuda, case, border, integer):
    levels = DESCRIBE_CASES[case]
    imgs, xy = _describe_inputs(cuda, levels, len(case) * 7 + border + 2 * integer, border, integer)
    counts = [n for _, n in levels]
    before = orb.describe_keypoints.launches
    ang, desc = orb.describe_keypoints(imgs, xy, counts)
    torch.cuda.synchronize()
    assert orb.describe_keypoints.launches == before + 1
    ref_ang, ref_desc = orb.describe_keypoints_plain(imgs, xy, counts)
    assert ang.shape == (xy.shape[0],) and desc.shape == (xy.shape[0], 256)
    assert torch.equal(ang, ref_ang)
    assert torch.equal(desc, ref_desc)


@pytest.mark.parametrize("mode", [pm.GATE_NONE, pm.GATE_WINDOW, pm.GATE_STEREO])
@pytest.mark.parametrize("na,nb", [(1024, 1024), (1000, 8192)])
def test_k2_equal_to_twin(cuda, mode, na, nb):
    rng = np.random.RandomState(na + nb + mode)
    a = np.where(rng.rand(na, 256) < 0.5, 1.0, -1.0).astype(np.float32)
    b = np.where(rng.rand(nb, 256) < 0.5, 1.0, -1.0).astype(np.float32)
    b[: na // 2] = np.where(rng.rand(na // 2, 256) < 0.04, -a[: na // 2], a[: na // 2])
    b[na // 2: na // 2 + 32] = b[na // 2 + 32: na // 2 + 64]     # column ties
    t = lambda x: torch.tensor(x, device=cuda)
    args = dict(
        a_bits=orb.pack_descriptors(t(a).bfloat16()), valid_a=t(rng.rand(na) < 0.95),
        b_bits=orb.pack_descriptors(t(b).bfloat16()), valid_b=t(rng.rand(nb) < 0.95),
        mode=mode, xy_a=t(rng.uniform(0, 640, (na, 2)).astype(np.float32)),
        xy_b=t(rng.uniform(0, 640, (nb, 2)).astype(np.float32)),
        level_a=t(rng.randint(0, 4, na).astype(np.int32)),
        level_b=t(rng.randint(0, 4, nb).astype(np.int32)),
        gate=t(np.array([96.0 * 96.0 if mode == pm.GATE_WINDOW else 2.0, 266.7], np.float32)))
    got = pm.hamming_top2(**args)
    ref = pm.hamming_top2_plain(**args)
    for f in pm.Top2._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def _k2_args(cuda, mode, na, nb, seed):
    """Random descriptors with planted near-duplicates, row ties (equal
    columns) and column ties (equal rows), positions and levels."""
    rng = np.random.RandomState(seed)
    a = np.where(rng.rand(na, 256) < 0.5, 1.0, -1.0).astype(np.float32)
    b = np.where(rng.rand(nb, 256) < 0.5, 1.0, -1.0).astype(np.float32)
    k = min(na, nb) // 2
    b[:k] = np.where(rng.rand(k, 256) < 0.04, -a[:k], a[:k])
    if nb >= 4:
        b[nb - 2:] = b[:2]                       # row ties: equal columns
    if na >= 4:
        a[na - 2:] = a[:2]                       # column ties: equal rows
    t = lambda x: torch.tensor(x, device=cuda)
    return dict(
        a_bits=orb.pack_descriptors(t(a).bfloat16()), valid_a=t(rng.rand(na) < 0.95),
        b_bits=orb.pack_descriptors(t(b).bfloat16()), valid_b=t(rng.rand(nb) < 0.95),
        mode=mode, xy_a=t(rng.uniform(0, 640, (na, 2)).astype(np.float32)),
        xy_b=t(rng.uniform(0, 640, (nb, 2)).astype(np.float32)),
        level_a=t(rng.randint(0, 4, na).astype(np.int32)),
        level_b=t(rng.randint(0, 4, nb).astype(np.int32)),
        gate=t(np.array([96.0 * 96.0 if mode == pm.GATE_WINDOW else 2.0, 266.7], np.float32)))


@pytest.mark.parametrize("design", sorted(pm.DESIGNS))
@pytest.mark.parametrize("mode", [pm.GATE_NONE, pm.GATE_WINDOW, pm.GATE_STEREO])
@pytest.mark.parametrize("na,nb", [(1, 1), (1, 513), (37, 513), (1000, 8000), (64, 33)])
def test_k2_ragged_equal_to_twin(cuda, design, mode, na, nb):
    """Every K2 design at shapes that are not multiples of its tiles."""
    args = _k2_args(cuda, mode, na, nb, na * 3 + nb + mode)
    before = pm.hamming_top2.launches
    got = pm.hamming_top2(**args, design=design)
    torch.cuda.synchronize()
    assert pm.hamming_top2.launches == before + 1
    ref = pm.hamming_top2_plain(**args)
    for f in pm.Top2._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.parametrize("blocks_per_sm", [1, 2, 8])
@pytest.mark.parametrize("na,nb", [(1024, 8192), (37, 513)])
def test_k2_column_splits_equal_to_twin(cuda, blocks_per_sm, na, nb):
    """The shipped design at other column splits than the default plan's:
    the split-and-merge gives the same outputs."""
    args = _k2_args(cuda, pm.GATE_WINDOW, na, nb, blocks_per_sm + na)
    plan = pm.top2_plan(na, nb, torch.cuda.get_device_properties(cuda).multi_processor_count,
                        blocks_per_sm)
    got = pm.hamming_top2(**args, plan=plan)
    ref = pm.hamming_top2_plain(**args)
    for f in pm.Top2._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.parametrize("G,iters", [(64, 192), (100, 37), (320, 512), (512, 512), (17, 0)])
def test_k3_equal_to_twin(cuda, G, iters):
    rng = np.random.RandomState(G + iters)
    step = torch.tensor((rng.rand(G, G) * 0.3 + 0.25).astype(np.float32), device=cuda)
    passable = torch.tensor(rng.rand(G, G) < 0.9, device=cuda)
    pot0 = np.full((G, G), pg.BIG, np.float32)
    pot0[G - 1, 0] = 0.0                     # goal at a corner cell
    pot0 = torch.tensor(pot0, device=cuda)
    before = pg.wavefront_sweeps.launches
    got = pg.wavefront_sweeps(pot0, step, passable, iters)
    assert pg.wavefront_sweeps.launches == before + 1
    assert torch.equal(got, pg.wavefront_sweeps_plain(pot0, step, passable, iters))
    assert pot0[G - 1, 0].item() == 0.0      # the input is not modified


@pytest.mark.parametrize("H,W,iters,design", [
    (64, 192, 37, "resident"), (333, 250, 300, "resident"), (1, 1, 5, "resident"),
    (1, 300, 9, "resident"), (90, 90, 64, "resident"), (512, 512, 200, "resident"),
    (513, 513, 37, "tiled"), (320, 320, 512, "tiled"), (64, 64, 192, "tiled"),
    (100, 37, 21, "tiled")])
def test_k3_ragged_equal_to_twin(cuda, H, W, iters, design):
    """Both K3 kernels at ragged shapes: non-square grids, a single cell, a
    grid just past the resident kernel's size rule, and sweep counts that
    are not a multiple of the tiled kernel's 8; the main-path sizes also go
    through the kernel the size rule does not pick for them."""
    rng = np.random.RandomState(H * 7 + W + iters)
    step = torch.tensor((rng.rand(H, W) * 0.3 + 0.25).astype(np.float32), device=cuda)
    passable = torch.tensor(rng.rand(H, W) < 0.85, device=cuda)
    pot0 = np.full((H, W), pg.BIG, np.float32)
    pot0[rng.randint(H), rng.randint(W)] = 0.0
    pot0[0, W - 1] = np.inf                      # above BIG on an edge cell
    pot0 = torch.tensor(pot0, device=cuda)
    ruled = pg.sweep_plan(H, W)
    plan = ruled if design == ruled.design else pg.TILED
    if design == "resident" and ruled.design != "resident":
        pytest.fail(f"({H}, {W}) is not resident under the size rule: {ruled}")
    before = pg.wavefront_sweeps.launches
    got = pg.wavefront_sweeps(pot0, step, passable, iters, plan=plan)
    torch.cuda.synchronize()
    assert pg.wavefront_sweeps.launches == before + 1
    assert torch.equal(got, pg.wavefront_sweeps_plain(pot0, step, passable, iters))


@pytest.mark.parametrize("group", [2, 4, 8])
@pytest.mark.parametrize("H,W,iters", [(320, 320, 512), (333, 250, 301), (90, 90, 63),
                                       (100, 37, 21), (64, 64, 3)])
def test_k3_grouped_exchange_equal_to_twin(cuda, H, W, iters, group):
    """The resident kernel with its bands exchanging rows every ``group``
    sweeps, sweep counts not a multiple of the group included."""
    rng = np.random.RandomState(H + W + iters + group)
    step = torch.tensor((rng.rand(H, W) * 0.3 + 0.25).astype(np.float32), device=cuda)
    passable = torch.tensor(rng.rand(H, W) < 0.85, device=cuda)
    pot0 = np.full((H, W), pg.BIG, np.float32)
    pot0[rng.randint(H), rng.randint(W)] = 0.0
    pot0 = torch.tensor(pot0, device=cuda)
    got = pg.wavefront_sweeps(pot0, step, passable, iters, plan=pg.sweep_plan(H, W, group))
    assert torch.equal(got, pg.wavefront_sweeps_plain(pot0, step, passable, iters))


def test_k3_wavefront_potential_on_rooms_world(cuda):
    spec = grid.GridSpec2D(320, 0.25, -40.0, -40.0)
    occ = torch.tensor(sim_robot.make_rooms_world(spec, seed=1), device=cuda)
    goal = torch.tensor([-37.0, -37.0], device=cuda)
    before = pg.wavefront_sweeps.launches
    pot = nav.wavefront_potential(spec, occ, goal, iters=512)
    assert pg.wavefront_sweeps.launches == before + 1
    occ_cpu = occ.cpu()
    ref = nav.wavefront_potential(spec, occ_cpu, goal.cpu(), iters=512)
    assert torch.equal(pot.cpu(), ref)


@pytest.mark.parametrize("na,nb", [(1024, 20480), (1000, 20001)])
def test_k2_loop_verification_equal_to_cpu(cuda, na, nb):
    """match_ratio_fused (loop verification: no gate, ratio 0.85, mutual
    check from K2's column argmin) with a sparse landmark mask of 300
    columns: the card's matches equal the CPU's (its plain twin)."""
    rng = np.random.RandomState(na + nb)
    a = np.where(rng.rand(na, 256) < 0.5, 1.0, -1.0).astype(np.float32)
    b = np.where(rng.rand(nb, 256) < 0.5, 1.0, -1.0).astype(np.float32)
    cols = rng.choice(nb, 300, replace=False)
    for i, c in enumerate(cols[:200]):            # planted matches, 0-12 flipped bits
        b[c] = np.where(rng.rand(256) < rng.uniform(0.0, 0.05), -a[i], a[i])
    b[cols[250]] = b[cols[251]] = a[300]          # a row tie
    vb = np.zeros(nb, bool)
    vb[cols] = True
    bits_a = orb.pack_descriptors(torch.tensor(a).to(torch.bfloat16))
    bits_b = orb.pack_descriptors(torch.tensor(b).to(torch.bfloat16))
    va = torch.ones(na, dtype=torch.bool)
    vb = torch.tensor(vb)
    before = pm.hamming_top2.launches
    got = pm.match_ratio_fused(bits_a.to(cuda), va.to(cuda), bits_b.to(cuda), vb.to(cuda),
                               max_distance=64, ratio=0.85, mutual=True)
    assert pm.hamming_top2.launches == before + 1
    ref = pm.match_ratio_fused(bits_a, va, bits_b, vb, max_distance=64, ratio=0.85, mutual=True)
    for x, y in zip(got, ref):
        assert torch.equal(x.cpu(), y)
    assert int(ref.valid.sum()) > 150


def test_render_repeats_and_equals_cpu(cuda):
    """The ring renderer sums overlapping blobs in a fixed order (F18): a
    frame rendered twice on the card is bit-equal, and equals the CPU's."""
    from fitslam_tpu_torch.data import synthetic
    from fitslam_tpu_torch.ops import lie
    from fitslam_tpu_torch.ops.geometry import Intrinsics

    T = synthetic.loop_trajectory(150, radius=8.0, device="cpu")
    pose = lie.SE3(T.R[40], T.t[40])
    out = []
    for dev in (cuda, cuda, torch.device("cpu")):
        K = Intrinsics(*(torch.tensor(v, dtype=torch.float32, device=dev)
                         for v in (400.0, 400.0, 320.0, 240.0, 0.2)))
        world = synthetic.load_ring_world(1, device=dev)
        out.append(synthetic.render_stereo(K, world, lie.SE3(pose.R.to(dev), pose.t.to(dev)),
                                           width=640, height=480, max_depth=14.0))
    for eye in range(2):
        assert torch.equal(out[0][eye], out[1][eye])
        assert torch.equal(out[0][eye].cpu(), out[2][eye])
    assert float(out[2][0].max()) > 100.0


def test_bundle_adjust_repeats_and_matches_cpu(cuda):
    """BA's normal equations add in a fixed order (F17): two card calls are
    bit-equal; against the CPU poses agree within 1e-4 m and points within
    1e-3 m (float32 LU solves and products of another order)."""
    from fitslam_tpu_torch.ops import ba, lie
    from fitslam_tpu_torch.ops.geometry import Intrinsics

    rng = np.random.RandomState(7)
    n_kf, n_lm = 6, 300
    pts = np.stack([rng.uniform(-4, 4, n_lm), rng.uniform(-2, 2, n_lm),
                    rng.uniform(4, 12, n_lm)], -1).astype(np.float32)
    xi = np.zeros((n_kf, 6), np.float32)
    xi[:, 0] = 0.3 * np.arange(n_kf)
    T_true = lie.se3_exp(torch.tensor(xi))
    kf, lm = np.repeat(np.arange(n_kf), n_lm), np.tile(np.arange(n_lm), n_kf)
    pc = (T_true.R.numpy()[kf] @ pts[lm][..., None])[..., 0] + T_true.t.numpy()[kf]
    u, v = 400 * pc[:, 0] / pc[:, 2] + 320, 400 * pc[:, 1] / pc[:, 2] + 240
    uvr = (np.stack([u, v, u - 80.0 / pc[:, 2]], -1)
           + rng.normal(scale=0.5, size=(len(kf), 3))).astype(np.float32)
    T0 = lie.compose(lie.se3_exp(torch.tensor(rng.normal(scale=0.02, size=(n_kf, 6)),
                                              dtype=torch.float32)), T_true)
    pts0 = pts + rng.normal(scale=0.05, size=pts.shape).astype(np.float32)

    def solve(d):
        K = Intrinsics(*(torch.tensor(x, dtype=torch.float32, device=d)
                         for x in (400.0, 400.0, 320.0, 240.0, 0.2)))
        obs = ba.Observations(torch.tensor(kf, dtype=torch.int32, device=d),
                              torch.tensor(lm, dtype=torch.int32, device=d),
                              torch.tensor(uvr, device=d), torch.ones(len(kf), device=d),
                              torch.ones(len(kf), dtype=torch.bool, device=d))
        prob = ba.BAProblem(lie.SE3(T0.R.to(d), T0.t.to(d)), torch.tensor(pts0, device=d), obs,
                            torch.arange(n_kf, device=d) == 0,
                            torch.zeros(n_lm, dtype=torch.bool, device=d))
        return ba.bundle_adjust(K, prob, iters=6)[0]

    a, b, c = solve(cuda), solve(cuda), solve(torch.device("cpu"))
    assert torch.equal(a.T_cw.t, b.T_cw.t) and torch.equal(a.T_cw.R, b.T_cw.R)
    assert torch.equal(a.points, b.points)
    np.testing.assert_allclose(a.T_cw.t.cpu().numpy(), c.T_cw.t.numpy(), atol=1e-4)
    np.testing.assert_allclose(a.points.cpu().numpy(), c.points.numpy(), atol=1e-3)


def test_dual_ekf_on_the_card_matches_cpu(cuda):
    """DualEkf on the card against its CPU run on the same rows (two flushes
    of more than one window each): x within 1e-5. Two runs on the card are
    bit-equal (the filter has no atomics)."""
    from fitslam_tpu_torch.models import localization as loc

    def run(d):
        rng = np.random.default_rng(21)
        dual = loc.DualEkf(device=d)
        out = []
        for _ in range(2):
            for k in range(40):
                v, w = 0.5 + 0.05 * rng.normal(), 0.3 + 0.05 * rng.normal()
                dual.add_odom(v, 0.0, 0.15)
                dual.add_imu(0.0, 0.0, w, 0.0, gate=0.8)
                if k % 2 == 0:
                    dual.add_pose(0.07 * k, 0.02 * k, 0.045 * k, gate=3.0)
            out.append(np.concatenate(dual.flush()))
        assert dual.windows == 8 and dual.host_syncs == 2
        return np.stack(out), dual.map_state.x.cpu().numpy()

    card, card_x = run(cuda)
    again, again_x = run(cuda)
    cpu, cpu_x = run(torch.device("cpu"))
    assert np.array_equal(card, again) and np.array_equal(card_x, again_x)
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-5)
    np.testing.assert_allclose(card_x, cpu_x, rtol=0, atol=1e-5)


def test_k3_r_wavefronts_in_a_row_equal_twin(cuda):
    """The coordinator's use of K3: R = 4 wavefronts in a row on one map, one
    from each rover, queued back to back, each equal to its plain twin."""
    spec = grid.GridSpec2D(64, 0.25, -8.0, -8.0)
    occ = torch.tensor(sim_robot.make_rooms_world(spec, seed=2), device=cuda)
    starts = [(-5.0, -5.0), (5.0, 5.0), (-5.0, 5.0), (5.0, -5.0)]
    before = pg.wavefront_sweeps.launches
    pots = [nav.wavefront_potential(spec, occ, torch.tensor(s, device=cuda), iters=192)
            for s in starts]
    assert pg.wavefront_sweeps.launches == before + len(starts)
    for s, pot in zip(starts, pots):
        ref = nav.wavefront_potential(spec, occ.cpu(), torch.tensor(s), iters=192)
        assert torch.equal(pot.cpu(), ref)


def test_coordinator_cost_matrix_on_the_card_equals_cpu(cuda, monkeypatch):
    """One MultiRobotCoordinator tick of 4 rovers on a partly explored map:
    the cost matrix, its assignment and the goals sent on the card equal the
    CPU's exactly (K3 against its twin, the gather and the host solver)."""
    from fitslam_tpu_torch.models import allocation as al

    spec = grid.GridSpec2D(64, 0.25, -8.0, -8.0)
    gt = torch.tensor(sim_robot.make_rooms_world(spec, seed=2))
    poses = [(np.array([-5.0, -5.0]), 0.0), (np.array([4.6, 5.2]), 3.0),
             (np.array([-4.4, 4.9]), -1.5), (np.array([5.1, -4.7]), 1.5)]
    explored = torch.full((64, 64), grid.UNKNOWN, dtype=torch.uint8)
    for xy, _ in poses:
        explored = sim_robot.reveal_sensor(spec, gt, explored,
                                           torch.tensor(xy, dtype=torch.float32), range_m=3.0)
    calls = []
    real = al.TaskAllocator.allocate

    def allocate(alloc, cost, fxy, peer_goals=None):
        a = real(alloc, cost, fxy, peer_goals)
        calls.append((np.array(cost), np.asarray(a)))
        return a

    monkeypatch.setattr(al.TaskAllocator, "allocate", allocate)

    class StillNav:
        def __init__(self):
            self.goals = []

        def send_goal(self, goal, heading):
            self.goals.append(np.asarray(goal))

        def cancel(self):
            pass

        def status(self):
            return None

    from fitslam_tpu_torch.run_multirobot import fleet_config

    goals = []
    for method in ("hungarian", "minpos", "auction"):
        for dev in (cuda, torch.device("cpu")):
            navs = [StillNav() for _ in poses]
            occ = explored.to(dev)
            coord = al.MultiRobotCoordinator(fleet_config(method), spec, lambda: occ, navs,
                                             lambda: poses, device=dev)
            before = pg.wavefront_sweeps.launches
            coord.tick()
            if dev.type == "cuda":
                assert pg.wavefront_sweeps.launches == before + len(poses)
            goals.append([n.goals for n in navs])
        (card_c, card_a), (cpu_c, cpu_a) = calls[-2:]
        assert np.array_equal(card_c, cpu_c) and np.array_equal(card_a, cpu_a)
        assert (card_c < al.BIG / 2).sum() > 10
        for gc, gcpu in zip(goals[-2], goals[-1]):
            assert len(gc) == len(gcpu) == 1 and np.array_equal(gc[0], gcpu[0])
