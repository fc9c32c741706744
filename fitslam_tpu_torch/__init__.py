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
the active-SLAM loop (``models.active_slam.ActiveSlamSystem``) with the dual
EKF of ``models/localization.py``; and recorded sequences through the TUM
reader (``data/tum.py``) and the native host runtime (``runtime/native.py``
over ``csrc/runtime.cc``, built with g++ at first use), driven by
``python -m fitslam_tpu_torch.run_dataset``. Their three hand-written Hopper
kernels live in ``csrc/`` and are built with nvcc at first use:

K1  ``csrc/patch_gather.cu``     (``ops/pallas_patches.py``) — ORB 40x40 patch gather
K2  ``csrc/hamming_top2.cu``     (``ops/pallas_matching.py``) — gated Hamming top-2
K3  ``csrc/wavefront_sweep.cu``  (``ops/pallas_grid.py``) — wavefront potential sweeps

This package imports ``torch`` and never ``jax``, and nothing of the
reference package either: the slices' configuration sections, the
evaluation helpers, the TUM reader and the native runtime's source are
copied here (``utils/config.py``, ``utils/evaluation.py``, ``data/tum.py``,
``csrc/runtime.cc``) and held equal to the reference by the tests. It reads
no file of the reference package either: the k-means vocabulary of place
recognition is the port's own copy, ``data/vocab_kmeans_256.npz``.
"""
