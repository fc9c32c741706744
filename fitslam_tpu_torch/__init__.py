"""fitslam_tpu_torch — the PyTorch + CUDA port of fitslam_tpu for one NVIDIA H100.

The JAX package ``fitslam_tpu`` is the reference: every module here names its
counterpart there (``ops/``, ``models/``, ``data/``, ``utils/``), keeps the
same NamedTuple field names, shapes and layouts at its public functions, and
is held against it by the parity tests in ``tests/test_torch_*.py``.

Two slices are ported. The stereo visual-SLAM frame step
(``models.slam.StereoSlam``) with loop closing and relocalization off, and
rapid-mode frontier exploration (``models.exploration.ExplorationServer`` and
``models.sim_nav.SimNavInterface`` under ``FitSlamConfig.preset("rapid")``).
Their three hand-written Hopper kernels live in ``csrc/`` and are built with
nvcc at first use:

K1  ``csrc/patch_gather.cu``     (``ops/pallas_patches.py``) — ORB 40x40 patch gather
K2  ``csrc/hamming_top2.cu``     (``ops/pallas_matching.py``) — gated Hamming top-2
K3  ``csrc/wavefront_sweep.cu``  (``ops/pallas_grid.py``) — wavefront potential sweeps

This package imports ``torch`` and never ``jax``, and nothing of the
reference package either: the slices' configuration sections, the
evaluation helpers and the PGM reader are copied here (``utils/config.py``,
``utils/evaluation.py``, ``data/tum.py``) and held equal to the reference by
the tests. It reads one data file of the reference, the k-means vocabulary
``fitslam_tpu/data/vocab_kmeans_256.npz``.
"""
