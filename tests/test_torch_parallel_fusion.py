"""Parity of the port's point-sharded traversability fusion
(``parallel/dist_stages.sharded_fuse_clouds``) with the reference's on the
conftest's 8-device virtual CPU mesh, with as many gloo ranks on the CPU as
the reference has devices (2 and 4; one launch of 4 ranks, each mesh the
first n of them), and with the port's single-rank fusion.

The cloud is made once with numpy (seed 0): 4096 points over a 64 x 64 grid
at 0.25 m, some outside it, a tenth masked off, a tenth raised as obstacles.

Tolerances: counts, z_min and z_max exactly; elevation and slope within
1e-5 (the ranks' partial sums are added in another order than XLA's psum
and than one sequential sum); roughness within 1e-3 (the square root of a
float32 cancellation, variance = sum z^2 / n - mean^2, turns a last-bit
difference of the sums in a cell of near-equal heights into ~1e-4); the
cost within 1 (``tests/test_torch_grid_fusion.py``'s rule).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitslam_tpu.ops import grid as jg
from fitslam_tpu.parallel import dist_stages as jds
from fitslam_tpu.parallel import mesh as jmesh
from fitslam_tpu_torch.ops import grid as tg
from fitslam_tpu_torch.utils import interop
from tests.test_torch_parallel_mesh import in_background, launch, rank_fusion

torch.set_num_threads(2)

SPEC_J = jg.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
SPEC_T = tg.GridSpec2D(size=64, resolution=0.25, origin_x=-8.0, origin_y=-8.0)
N_PTS = 4096


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.RandomState(0)
    xy = rng.uniform(-8.5, 8.5, (N_PTS, 2))
    z = 0.1 * np.sin(xy[:, 0]) + np.where(rng.rand(N_PTS) < 0.1, rng.uniform(0, 2, N_PTS), 0.0)
    pts = np.concatenate([xy, (z + rng.normal(0, 0.02, N_PTS))[:, None]], 1).astype(np.float32)
    return pts, rng.rand(N_PTS) > 0.1


SIZES = (4, 2)


@pytest.fixture(scope="module")
def runs(cloud):
    """The port's fusion for both n in one launch of 4 ranks, in the
    background; ``runs.result()[n]`` holds each rank's grid."""
    pts, ok = cloud

    def go():
        res = launch(rank_fusion, max(SIZES), SIZES, SPEC_T, torch.tensor(pts), torch.tensor(ok))
        return {size: [r[size] for r in res[:size]] for size in SIZES}
    return in_background(go)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_fuse_clouds_matches_reference(cloud, runs, n):
    pts, ok = cloud
    # jitted: the reference's shard_map run eagerly compiles op by op (~10 s)
    fuse = jax.jit(functools.partial(jds.sharded_fuse_clouds, jmesh.make_mesh(n), SPEC_J))
    ref = jax.tree.map(np.asarray, fuse(jnp.asarray(pts), jnp.asarray(ok)))
    single = interop.to_numpy(tg.stats_to_grid(SPEC_T, tg.cell_stats(
        SPEC_T, torch.tensor(pts), torch.tensor(ok))))
    for grid in runs.result()[n]:
        got = interop.to_numpy(grid)
        for other in (ref, single):
            for name in ("count", "z_min", "z_max"):
                np.testing.assert_array_equal(getattr(got, name), getattr(other, name),
                                              err_msg=name)
            for name, tol in (("elevation", 1e-5), ("slope", 1e-5), ("roughness", 1e-3)):
                np.testing.assert_allclose(getattr(got, name), getattr(other, name), atol=tol,
                                           err_msg=name)
            assert np.abs(got.cost.astype(int) - other.cost.astype(int)).max() <= 1
        assert (got.count > 0).sum() > 1000
