"""fitslam_tpu_torch — the PyTorch + CUDA port of fitslam_tpu for one NVIDIA H100.

The JAX package ``fitslam_tpu`` is the reference: every module here names its
counterpart there (``ops/``, ``models/``, ``data/``, ``utils/``), keeps the
same NamedTuple field names, shapes and layouts at its public functions, and
is held against it by the parity tests in ``tests/test_torch_*.py``.

Ported so far: the stereo and RGB-D visual-SLAM engine
(``models.slam.StereoSlam``) with loop closing, relocalization and the
Atlas (``models/loop_closing.py``, ``ops/pgo.py``); rapid-mode frontier
exploration (``models.exploration.ExplorationServer`` and
``models.sim_nav.SimNavInterface`` under ``FitSlamConfig.preset("rapid")``);
and the active-SLAM loop (``models.active_slam.ActiveSlamSystem``, the EKF
off). Their three hand-written Hopper kernels live in ``csrc/`` and are built
with nvcc at first use:

K1  ``csrc/patch_gather.cu``     (``ops/pallas_patches.py``) — ORB 40x40 patch gather
K2  ``csrc/hamming_top2.cu``     (``ops/pallas_matching.py``) — gated Hamming top-2
K3  ``csrc/wavefront_sweep.cu``  (``ops/pallas_grid.py``) — wavefront potential sweeps

This package imports ``torch`` and never ``jax``, and nothing of the
reference package either: the slices' configuration sections, the
evaluation helpers and the PGM reader are copied here (``utils/config.py``,
``utils/evaluation.py``, ``data/tum.py``) and held equal to the reference by
the tests. It reads no file of the reference package either: the k-means
vocabulary of place recognition is the port's own copy,
``data/vocab_kmeans_256.npz``.
"""
