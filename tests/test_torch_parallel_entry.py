"""The port's multi-process runner (``python -m
fitslam_tpu_torch.parallel.multihost``) on the CPU beside the reference's
(``fitslam_tpu.parallel.multihost``), both as two processes of one CPU
device each, and the slice's two leftovers: ``ops/orb.unpack_descriptors``
and ``runtime/native.ensure_built``.

Tolerances: ``build_problem``'s draws (landmarks, indices, noisy points)
exactly, its poses within 1e-5 relative (``se3_exp`` in another order of
float32 operations) and its pixels within 1e-4 px; the runs' chi2 within
1e-4 relative; the descriptors exactly.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fitslam_tpu.ops import orb as jorb
from fitslam_tpu.parallel import multihost as jmultihost
from fitslam_tpu_torch.ops import orb as torb
from fitslam_tpu_torch.parallel import multihost
from fitslam_tpu_torch.runtime import native

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_processes(module, extra, env):
    """Start ``python -m module`` as processes 0 and 1 of a two-process run."""
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", module, "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(pid), "--obs", "512", "--iters", "4",
         *extra], cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in (0, 1)]


def _results(procs):
    """Each process's MULTIHOST_RESULT, once both have exited with 0."""
    results = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out[-2000:]
        line = [ln for ln in out.splitlines() if ln.startswith("MULTIHOST_RESULT ")][-1]
        results.append(json.loads(line.split(" ", 1)[1]))
    return results


def test_build_problem_matches_reference():
    K_ref, ref = jax.tree.map(np.asarray, jmultihost.build_problem(n_obs=512))
    K, got = multihost.build_problem(n_obs=512, device="cpu")
    for name in ("kf", "lm", "sigma2", "valid"):
        np.testing.assert_array_equal(getattr(got.obs, name).numpy(), getattr(ref.obs, name))
    np.testing.assert_array_equal(got.points.numpy(), ref.points)
    np.testing.assert_array_equal(got.fixed_kf.numpy(), ref.fixed_kf)
    np.testing.assert_allclose(got.T_cw.R.numpy(), ref.T_cw.R, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.T_cw.t.numpy(), ref.T_cw.t, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.obs.uvr.numpy(), ref.obs.uvr, atol=1e-4)
    assert float(K.fx) == float(K_ref.fx) == 120.0


def test_two_process_multihost_matches_reference():
    """Two OS processes joined over TCP, the observation shards split across
    them; each prints the reference's MULTIHOST_RESULT line, and the chi2
    agrees with the reference's two-process run on the same problem."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    # the two runs side by side
    port_procs = _two_processes("fitslam_tpu_torch.parallel.multihost", ["--cpu"], env)
    ref_procs = _two_processes("fitslam_tpu.parallel.multihost", ["--local-devices", "1"],
                               dict(env, JAX_PLATFORMS="cpu"))
    try:
        got, ref = _results(port_procs), _results(ref_procs)
    finally:
        for p in port_procs + ref_procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r in got:
        assert r["n_processes"] == 2 and r["n_devices"] == 2 and r["device"] == "cpu"
        assert r["chi2_last"] < r["chi2_first"] * 0.2
        for key in ("chi2_first", "chi2_last"):
            np.testing.assert_allclose(r[key], ref[0][key], rtol=1e-4)
    assert {r["process_id"] for r in got} == {0, 1}
    assert got[0]["chi2_last"] == got[1]["chi2_last"]
    assert ref[0]["n_devices"] == 2


def test_unpack_descriptors_matches_reference():
    rng = np.random.RandomState(3)
    desc = np.where(rng.rand(37, 256) > 0.5, 1.0, -1.0).astype(np.float32)
    packed_ref = np.asarray(jorb.pack_descriptors(jnp.asarray(desc, jnp.bfloat16)))
    ref = np.asarray(jorb.unpack_descriptors(jnp.asarray(packed_ref)).astype(jnp.float32))
    packed = torb.pack_descriptors(torch.tensor(desc).to(torch.bfloat16))
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), packed_ref)
    got = torb.unpack_descriptors(packed)
    assert got.dtype == torch.bfloat16 and got.shape == (37, 256)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    np.testing.assert_array_equal(got.float().numpy(), desc)
    # the reference's uint32 words unpack alike
    from_u32 = torb.unpack_descriptors(torch.tensor(packed_ref.astype(np.int64)))
    assert torch.equal(from_u32, got)


def test_ensure_built():
    assert native.ensure_built() is True
    assert native.load_library() is not None
