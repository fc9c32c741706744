"""The BA and PGO solvers as captured programs (``utils/jit.py``) on the
CPU, where every region runs eagerly through the same static input, state
and output buffers a CUDA graph replays from: ``ops/ba.BundleAdjuster``
(region ``ba_solve``), the observation-sharded BA (``obs_blocks``,
``obs_step``), the landmark-sharded BA and ``slam_map.global_ba_dist``
(``lm_blocks``, ``lm_schur``, ``lm_solve``) and the edge-sharded PGO
(``pgo_assemble``, ``pgo_solve``); and on the card, captured against eager.

The sharded solvers run on gloo ranks on the CPU, one launch of 4 ranks
serving n = 4, 2 and 1 (each mesh the first n of them), at the reference
tests' sizes: ``bench_suite.make_ba_problem`` draws
``tests/test_ba.py::_make_problem``'s problem (4 keyframes, 128 landmarks,
1024 observations) bit for bit, ``tests/test_slam_map.py::_multiview_map``
is handed over through ``utils.interop``, and the PGO ring is
``tests/test_torch_parallel_stages.py``'s shape (16 keyframes, 32 edges).

- Bit-equality: each solver's captured default equals ``capture=False``
  exactly, on every rank, on two problems of one shape and again on the
  first (the mesh's slot reused), with the reductions an iteration
  unchanged (2 observation-sharded, 6 landmark-sharded, 2 PGO).
- The split step: ``ba.reduced_step`` (``schur_terms`` then
  ``schur_solve``) equals the one-piece step it replaced exactly.
- Kept results: a solve's result is unchanged by one more solve on the
  same slot.
- Nesting: a solver's region entered inside another region raises.
- Capture safety: each region, as ``tests/test_torch_jit_sim.py``'s
  recorder sees it, runs the same operations on every call, with no host
  read, no data-dependent shape and no upload after its first call.

Parity with the JAX package stays with ``tests/test_torch_parallel_ba.py``,
``test_torch_parallel_stages.py``, ``test_torch_parallel_dryrun.py`` and
``test_torch_bench.py``, which now run the captured default.

The card tests import no JAX:

    python3 -m pytest --noconftest -m gpu tests/test_torch_jit_solvers.py
"""

import numpy as np
import pytest
import torch

from fitslam_tpu_torch import bench_suite
from fitslam_tpu_torch.ops import ba as tba
from fitslam_tpu_torch.ops import lie as tlie
from fitslam_tpu_torch.ops import pgo as tpgo
from fitslam_tpu_torch.parallel import mesh as mesh_mod
from fitslam_tpu_torch.utils import jit, prng
from test_torch_parallel_mesh import in_background, launch

torch.set_num_threads(2)

SIZES = (4, 2, 1)
RECORD_N = 2              # the mesh whose regions the capture-safety recorder watches
ITERS = 4
PGO_ITERS = 5
K_PGO = 16
BA_SHAPE = dict(n_kf=4, n_lm=128, n_obs=1024)
SOLVER_NAMES = {"obs": "distributed_bundle_adjust", "lm": "landmark_sharded_bundle_adjust",
                "pgo": "distributed_pose_graph", "gba": "landmark_sharded_bundle_adjust"}
REGIONS = {"obs": ("obs_blocks", "obs_step"), "lm": ("lm_blocks", "lm_schur", "lm_solve"),
           "pgo": ("pgo_assemble", "pgo_solve"), "gba": ("lm_blocks", "lm_schur", "lm_solve")}
COLLECTIVES = {"obs": 2 * ITERS, "lm": 6 * ITERS + 1, "pgo": 2 * PGO_ITERS,
               "gba": 6 * ITERS + 1}


def _leaves(tree):
    return jit.flatten(tree)[0]


def _equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def _ba_problems():
    """tests/test_ba.py's problem (key 7) and the same problem with its
    free poses and points moved: two problems of one shape."""
    prob, _, _ = bench_suite.make_ba_problem(prng.prng_key(7), **BA_SHAPE, device="cpu")
    rng = np.random.RandomState(1)
    dT = tlie.se3_exp(torch.tensor(0.01 * rng.randn(BA_SHAPE["n_kf"], 6), dtype=torch.float32))
    T = tlie.compose(dT, prob.T_cw)
    keep = prob.fixed_kf
    T = tlie.SE3(torch.where(keep[:, None, None], prob.T_cw.R, T.R),
                 torch.where(keep[:, None], prob.T_cw.t, T.t))
    pts = prob.points + torch.tensor(0.05 * rng.randn(*prob.points.shape), dtype=torch.float32)
    return prob, prob._replace(T_cw=T, points=pts)


def _pgo_inputs():
    """A ring of 16 keyframes with odometry and loop edges from the truth
    (32 edges), and two perturbed starts; keyframe 0 holds the gauge."""
    rng = np.random.RandomState(0)
    s = np.linspace(0, 2 * np.pi, K_PGO, endpoint=False)
    T_gt = tlie.SE3(tlie.yaw_to_rotmat(torch.tensor(s, dtype=torch.float32)),
                    torch.tensor(np.stack([5 * np.cos(s), 5 * np.sin(s), 0 * s], -1),
                                 dtype=torch.float32))
    odo = tpgo.odometry_edges(T_gt, torch.tensor(K_PGO, dtype=torch.int32), K_PGO)
    li = rng.randint(0, K_PGO, 16)
    lj = (li + rng.randint(2, K_PGO - 1, 16)) % K_PGO
    take = lambda idx: tlie.SE3(T_gt.R[idx], T_gt.t[idx])
    loops = tpgo.PoseGraphEdges(torch.tensor(li, dtype=torch.int32),
                                torch.tensor(lj, dtype=torch.int32),
                                tlie.compose(take(li), tlie.inverse(take(lj))),
                                torch.full((16,), 2.0), torch.tensor(rng.rand(16) > 0.25))
    starts = []
    for _ in range(2):
        T0 = tlie.compose(tlie.se3_exp(torch.tensor(0.05 * rng.randn(K_PGO, 6),
                                                    dtype=torch.float32)), T_gt)
        R, t = T0.R.clone(), T0.t.clone()
        R[0], t[0] = T_gt.R[0], T_gt.t[0]
        starts.append(tlie.SE3(R, t))
    fixed = torch.arange(K_PGO) == 0
    return starts, torch.ones(K_PGO, dtype=torch.bool), tpgo.concat_edges(odo, loops), fixed


# ---------------------------------------------------------------------------
# The capture-safety recorder (tests/test_torch_jit_sim.py's), around calls
# ---------------------------------------------------------------------------


def _recording(calls, regions):
    """Run ``calls()`` with the recorder around every call of the regions
    named in ``regions``: returns (calls' result, {region: [each slot's op
    sequence of each call]})."""
    from test_torch_jit_sim import _Recorder

    seqs, running = {}, []
    real_run, real_call = jit._run_region, jit.CapturedStep.__call__

    def call(region, *args):
        running.append(region)
        try:
            return real_call(region, *args)
        finally:
            running.pop()

    def recording(fn, args):
        region = running[-1]
        if region.name not in regions:
            return real_run(fn, args)
        with _Recorder() as rec:
            result = real_run(fn, args)
        seqs.setdefault(region.name, {}).setdefault(id(region.slot), []).append(rec.ops)
        return result

    jit.CapturedStep.__call__, jit._run_region = call, recording
    try:
        result = calls()
    finally:
        jit.CapturedStep.__call__, jit._run_region = real_call, real_run
    return result, {name: list(slots.values()) for name, slots in seqs.items()}


def _nested_error(call, device="cpu"):
    """The error of ``call()`` run inside another region (None if none)."""
    slot = jit.Slot(device, {})
    try:
        slot.run("outer", lambda: ((), call()))
    except RuntimeError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# Rank side (spawned ranks import this module: no JAX at its top level)
# ---------------------------------------------------------------------------


def rank_solvers(sizes, K, probs, pgo_in, K_map, maps, device="cpu"):
    """For each n of ``sizes``, on the first n ranks: every sharded solver
    with ``capture=False`` on both inputs, then captured on input 0, input
    1 and input 0 again (one slot of the mesh), the first captured result
    held to a copy of itself after the next solve; the collectives of a
    captured solve; its regions' stats; at n = RECORD_N the regions' op
    records and each solver entered inside another region."""
    from fitslam_tpu_torch.models import slam_map as sm
    from fitslam_tpu_torch.parallel import dist_ba
    from fitslam_tpu_torch.parallel import dist_stages as ds

    to = lambda tree: mesh_mod.map_tree(lambda x: x.to(device), tree)
    K, probs, pgo_in, K_map, maps = to(K), to(probs), to(pgo_in), to(K_map), to(maps)
    T0s, kf_valid, edges, fixed = pgo_in
    out = {}
    for n in sizes:
        mesh = mesh_mod.make_mesh(n)
        if mesh.rank < 0:
            continue
        packed = [dist_ba.shard_problem_by_landmark(p, n) for p in probs]
        solve = {
            "obs": lambda k, cap: dist_ba.distributed_bundle_adjust(mesh, K, probs[k],
                                                                    iters=ITERS, capture=cap),
            "lm": lambda k, cap: dist_ba.landmark_sharded_bundle_adjust(
                mesh, K, packed[k], iters=ITERS, capture=cap),
            "pgo": lambda k, cap: ds.distributed_pose_graph(mesh, T0s[k], kf_valid, edges, fixed,
                                                            iters=PGO_ITERS, capture=cap),
            "gba": lambda k, cap: sm.global_ba_dist(maps[k], K_map, mesh, iters=ITERS,
                                                    capture=cap),
        }
        res = {}
        for name, fn in solve.items():
            eager = [fn(k, False) for k in (0, 1)]

            def captured():
                c0 = mesh.stats["collectives"]
                kept = fn(0, True)
                collectives = mesh.stats["collectives"] - c0
                want = jit.clone(kept)
                other = fn(1, True)
                return [kept, other, fn(0, True)], _equal(kept, want), collectives

            if n == RECORD_N:
                (runs, intact, collectives), ops = _recording(captured, REGIONS[name])
            else:
                (runs, intact, collectives), ops = captured(), None
            res[name] = dict(eager=eager, captured=runs, kept_intact=intact,
                             collectives=collectives, ops=ops,
                             stats=mesh.solvers[SOLVER_NAMES[name]].state.stats())
            if n == RECORD_N:
                res[name]["nested"] = _nested_error(lambda: fn(0, True), device)
        out[n] = res
    return out


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ba_problems():
    return _ba_problems()


@pytest.fixture(scope="module")
def runs(ba_problems):
    """Every rank's results for each n of SIZES, from one launch of 4 ranks
    in the background; ``runs.result()[n]`` is the list of the mesh's
    ranks' results."""
    import jax

    from fitslam_tpu_torch.utils import interop
    from test_slam_map import K as K_MAP
    from test_slam_map import _multiview_map

    m, _, _ = _multiview_map(jax.random.PRNGKey(7))
    m = interop.to_torch(jax.tree.map(np.asarray, m))
    moved = m._replace(lm_pos=m.lm_pos + 0.02)
    K_map = interop.to_torch(jax.tree.map(np.asarray, K_MAP))

    def go():
        res = launch(rank_solvers, max(SIZES), SIZES, bench_suite.ba_intrinsics("cpu"),
                     ba_problems, _pgo_inputs(), K_map, (m, moved))
        return {n: [r[n] for r in res[:n]] for n in SIZES}
    return in_background(go)


# ---------------------------------------------------------------------------
# (a) the sharded solvers: captured against capture=False
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("solver", list(SOLVER_NAMES))
def test_sharded_solver_through_buffers_equals_eager(runs, solver, n):
    """Captured on input 0, input 1 and input 0 again on one slot, bit-equal
    to ``capture=False`` on the same inputs, on every rank of the mesh, the
    same on every rank; the reductions of a solve unchanged; every solve
    ran through the slot's regions."""
    ranks = runs.result()[n]
    for r in ranks:
        got = r[solver]
        eager = got["eager"]
        for run, want in zip(got["captured"], (eager[0], eager[1], eager[0])):
            assert _equal(run, want)
        assert not _equal(eager[0], eager[1])
        assert got["collectives"] == COLLECTIVES[solver]
        iters = PGO_ITERS if solver == "pgo" else ITERS
        for region in REGIONS[solver]:
            assert got["stats"][region]["calls"] == 3 * iters, (region, got["stats"])
        assert _equal(got["captured"], ranks[0][solver]["captured"])


@pytest.mark.parametrize("solver", list(SOLVER_NAMES))
def test_sharded_kept_result_survives_the_next_solve(runs, solver):
    """A captured solve's returned result (the problem, the map written
    back, the chi2 history) is unchanged by the next solve on the same
    slot, at every n."""
    for n in SIZES:
        assert all(r[solver]["kept_intact"] for r in runs.result()[n]), n


@pytest.mark.parametrize("solver", list(SOLVER_NAMES))
def test_sharded_solver_inside_a_region_raises(runs, solver):
    """On every rank, a captured solver called from inside another region
    raises at its first region, before any reduction."""
    for r in runs.result()[RECORD_N]:
        err = r[solver]["nested"]
        assert err is not None and "inside region outer" in err, err


# ---------------------------------------------------------------------------
# (b) BundleAdjuster (ops/ba.py)
# ---------------------------------------------------------------------------


def _adjuster(iters=ITERS):
    return tba.BundleAdjuster("cpu", **BA_SHAPE, iters=iters, damping=1e-3)


@pytest.fixture(scope="module")
def adjusted(ba_problems):
    """BundleAdjuster on problem 0, 1 and 0 again (one slot), recorded; the
    plain function on both; the first result against its copy after the
    next solve."""
    K = bench_suite.ba_intrinsics("cpu")
    adjuster = _adjuster()

    def solves():
        kept = adjuster(K, ba_problems[0])
        want = jit.clone(kept)
        other = adjuster(K, ba_problems[1])
        return [kept, other, adjuster(K, ba_problems[0])], _equal(kept, want)

    (got, intact), ops = _recording(solves, ("ba_solve",))
    plain = [tba.bundle_adjust(K, p, iters=ITERS, damping=1e-3) for p in ba_problems]
    return dict(got=got, intact=intact, ops=ops, plain=plain, stats=adjuster.capture_stats)


def test_bundle_adjuster_through_buffers_equals_plain(adjusted):
    want = adjusted["plain"]
    for run, w in zip(adjusted["got"], (want[0], want[1], want[0])):
        assert _equal(run, w)
    assert adjusted["stats"]["ba_solve"]["calls"] == 3
    eager = tba.BundleAdjuster("cpu", **BA_SHAPE, iters=ITERS, damping=1e-3, capture=False)
    assert _equal(eager(bench_suite.ba_intrinsics("cpu"), _ba_problems()[0]), want[0])
    assert eager.capture_stats == {}


def test_bundle_adjuster_kept_result_survives_the_next_solve(adjusted):
    assert adjusted["intact"]


def test_bundle_adjuster_refuses_another_shape(ba_problems):
    prob, _, _ = bench_suite.make_ba_problem(prng.prng_key(7), 4, 128, 512, device="cpu")
    with pytest.raises(ValueError, match="given a problem of"):
        _adjuster()(bench_suite.ba_intrinsics("cpu"), prob)


def test_bundle_adjuster_inside_a_region_raises(ba_problems):
    K = bench_suite.ba_intrinsics("cpu")
    err = _nested_error(lambda: _adjuster()(K, ba_problems[0]))
    assert err is not None and "region ba_solve entered inside region outer" in err
    # the plain function, which the frame step's regions call, still runs there
    assert _nested_error(lambda: tba.bundle_adjust(K, ba_problems[0], iters=1)) is None


def _one_piece_step(fixed_kf, fixed_lm, blocks, damping):
    """The Gauss-Newton step as one function, as ``ba.reduced_step`` stood
    before its split into ``schur_terms`` and ``schur_solve``."""
    Hpp, Hll, bp, bl, Y = blocks[:5]
    K_n = Hpp.shape[0]
    dev = Hpp.device
    eye3 = torch.eye(3, dtype=Hll.dtype, device=dev)
    diag_l = torch.einsum("lii->l", Hll)[:, None, None] / 3.0
    Hll_d = Hll + (0.05 * diag_l + damping + 1e-6) * eye3
    empty_lm = torch.abs(Hll).sum(dim=(-2, -1)) < 1e-10
    Hll_d = torch.where(empty_lm[:, None, None], eye3, Hll_d)
    Hll_inv = tba.inv3x3(Hll_d)
    Hll_inv = torch.where(empty_lm[:, None, None], torch.zeros_like(eye3), Hll_inv)
    lm_free = torch.logical_not(fixed_lm)
    Hll_inv = Hll_inv * lm_free[:, None, None]
    YHinv = torch.einsum("klij,ljm->klim", Y, Hll_inv)
    S_l = torch.einsum("alim,bljm->abij", YHinv, Y)
    b_l = torch.einsum("klim,lm->ki", YHinv, bl)
    S = -S_l
    diag = torch.arange(K_n, device=dev)
    S[diag, diag] = S[diag, diag] + Hpp
    b_schur = bp - b_l
    free = torch.logical_not(fixed_kf).to(S.dtype)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    eye6 = torch.eye(6, dtype=S.dtype, device=dev)
    S[diag, diag] = S[diag, diag] + eye6 * fixed_kf.to(S.dtype)[:, None, None]
    b_schur = b_schur * free[:, None]
    S[diag, diag] = S[diag, diag] + eye6 * damping
    S_mat = S.permute(0, 2, 1, 3).reshape(K_n * 6, K_n * 6)
    dp = torch.linalg.solve_ex(S_mat, b_schur.reshape(K_n * 6))[0].reshape(K_n, 6)
    Yt_dp = torch.einsum("klim,ki->lm", Y, dp)
    dl = torch.einsum("lij,lj->li", Hll_inv, bl - Yt_dp)
    dl = dl * lm_free[:, None]
    dp = dp * torch.logical_not(fixed_kf)[:, None]
    dp_n = torch.linalg.norm(dp, dim=-1, keepdim=True)
    dp = dp * torch.clamp(0.5 / torch.clamp(dp_n, min=1e-12), max=1.0)
    dl_n = torch.linalg.norm(dl, dim=-1, keepdim=True)
    dl = dl * torch.clamp(1.0 / torch.clamp(dl_n, min=1e-12), max=1.0)
    return dp, dl


@pytest.mark.parametrize("damping", [1e-4, 1e-3])
def test_split_step_equals_the_one_piece_step(ba_problems, damping):
    """``reduced_step`` (``schur_terms`` then ``schur_solve``) on the blocks
    of a problem with a held landmark and an unobserved one equals the
    one-piece step exactly."""
    prob = ba_problems[1]
    K = bench_suite.ba_intrinsics("cpu")
    fixed_lm = prob.fixed_lm.clone()
    fixed_lm[3] = True
    valid = prob.obs.valid & (prob.obs.lm != 5)
    prob = prob._replace(fixed_lm=fixed_lm, obs=prob.obs._replace(valid=valid))
    res, J_pose, J_point, w, ok, _ = tba.linearize(K, prob)
    w = torch.where(ok, w, torch.zeros_like(w))
    plans = tba.sum_plans(prob.obs, BA_SHAPE["n_kf"], BA_SHAPE["n_lm"])
    blocks = tba.schur_blocks(prob, res, J_pose, J_point, w, plans)
    assert float(torch.abs(blocks[1][5]).sum()) == 0.0
    got = tba.reduced_step(prob.fixed_kf, prob.fixed_lm, blocks, damping)
    want = _one_piece_step(prob.fixed_kf, prob.fixed_lm, blocks, damping)
    assert _equal(got, want)
    assert float(torch.abs(got[1][3]).sum()) == 0.0 and float(torch.abs(got[0]).sum()) > 0


# ---------------------------------------------------------------------------
# (c) capture safety
# ---------------------------------------------------------------------------


ALL_REGIONS = ["ba_solve", "obs_blocks", "obs_step", "lm_blocks", "lm_schur", "lm_solve",
               "pgo_assemble", "pgo_solve"]


@pytest.mark.parametrize("region", ALL_REGIONS)
def test_regions_are_capture_safe(runs, adjusted, region):
    """Each region, on every call (iterations and problems of different
    content), runs the same operations with the same output shapes and
    types, none of them a host read, a data-dependent shape or (after its
    first call) an upload."""
    from test_torch_jit_sim import FORBIDDEN, UPLOADS

    if region == "ba_solve":
        slots = adjusted["ops"][region]
    else:
        slots = [seqs for solver, names in REGIONS.items() if region in names
                 for seqs in runs.result()[RECORD_N][0][solver]["ops"][region]]
    assert slots
    for seqs in slots:
        assert len(seqs) >= 3, (region, [len(q) for q in slots])
        assert all(q == seqs[0] for q in seqs), f"region {region}: operations differ between calls"
        bad = {op[0] for seq in seqs for op in seq if op[1] or op[0].startswith(FORBIDDEN)}
        assert not bad, f"region {region} holds {sorted(bad)}"
        uploads = {op[0] for seq in seqs[1:] for op in seq if op[0].startswith(UPLOADS)}
        assert not uploads, f"region {region} uploads host data at every call: {uploads}"


# ---------------------------------------------------------------------------
# (d) on the card: captured against eager
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_captured_solvers_equal_eager_on_the_card():
    """On cuda:0: BundleAdjuster and every sharded solver over 1 and 2
    ranks sharing the card over gloo, captured (warm-up, capture, replays)
    bit-equal to ``capture=False``; a solver entered inside a capture or
    another region raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    dev = torch.device("cuda", 0)
    K = bench_suite.ba_intrinsics(dev)
    probs = [mesh_mod.map_tree(lambda x: x.to(dev), p) for p in _ba_problems()]
    adjuster = tba.BundleAdjuster(dev, **BA_SHAPE, iters=ITERS, damping=1e-3)
    for prob in (probs[0], probs[1], probs[0], probs[1]):
        assert _equal(adjuster(K, prob), tba.bundle_adjust(K, prob, iters=ITERS, damping=1e-3))
    assert adjuster.capture_stats["ba_solve"]["captured"]
    err = _nested_error(lambda: adjuster(K, probs[0]), dev)
    assert err is not None and "inside region outer" in err
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="inside region|being captured"):
        with torch.cuda.graph(g):
            adjuster(K, probs[0])

    # tests/test_slam_map.py's map is made with JAX: the card test uses a
    # map of the frame step instead, built by global_ba's own test set-up
    cpu_probs = _ba_problems()
    res = mesh_mod.launch(rank_solvers, 2, (2, 1), bench_suite.ba_intrinsics("cpu"), cpu_probs,
                          _pgo_inputs(), bench_suite.ba_intrinsics("cpu"),
                          (_ba_map(cpu_probs[0]), _ba_map(cpu_probs[1])), str(dev),
                          backend="gloo", device=str(dev), timeout=600)
    for n in (2, 1):
        for r in res[:n]:
            for solver in SOLVER_NAMES:
                got = r[n][solver]
                eager = got["eager"]
                for run, want in zip(got["captured"], (eager[0], eager[1], eager[0])):
                    assert _equal(run, want), (n, solver)
                assert got["kept_intact"] and got["collectives"] == COLLECTIVES[solver]
                assert all(got["stats"][k]["captured"] for k in REGIONS[solver]), got["stats"]


def _ba_map(prob):
    """A SlamMap holding a BA problem (its keyframes, landmarks and
    observations) for global_ba_dist on the card."""
    from fitslam_tpu_torch.models import slam_map as sm

    K_n, L_n, O_n = BA_SHAPE["n_kf"], BA_SHAPE["n_lm"], BA_SHAPE["n_obs"]
    m = sm.empty_map(K_n, L_n, O_n, device="cpu")
    obs = prob.obs
    a = torch.zeros(L_n, dtype=torch.int32)
    return m._replace(kf_T_cw=prob.T_cw, kf_valid=torch.ones(K_n, dtype=torch.bool),
                      n_kf=torch.tensor(K_n, dtype=torch.int32), lm_pos=prob.points,
                      lm_valid=torch.ones(L_n, dtype=torch.bool), lm_anchor_kf=a,
                      obs_kf=obs.kf, obs_lm=obs.lm, obs_uvr=obs.uvr, obs_sigma2=obs.sigma2,
                      obs_valid=obs.valid)
