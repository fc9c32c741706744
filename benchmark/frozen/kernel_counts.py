"""The bytes and operations each hand-written kernel of the port must move
and compute, and the card's published peaks they are held to: frozen copies
of ``fitslam_tpu_torch/bench_suite.py`` (``HBM_BYTES_PER_S`` and
``PEAK_OPS_PER_S`` :62-63, ``bound`` :161-168, ``describe_bytes_ops``
:1020-1027, ``k2_bytes`` :1047-1051, and K3's count at :1123-1127).

Peaks: NVIDIA's data sheet for one H100 SXM at its 700 W limit, dense
rates. Bytes count each input read once and each output written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "f32": 67e12}

# K2's gate modes (fitslam_tpu_torch/ops/pallas_matching.py: GATE_NONE,
# GATE_WINDOW, GATE_STEREO)
GATE_NONE, GATE_WINDOW, GATE_STEREO = 0, 1, 2


def bound_s(n_bytes: float, n_ops: float, op_type: str) -> float:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak of their type, whichever is larger (s)."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[op_type])


def k1_bytes_ops(levels, n: int):
    """K1, the fused ORB describe of one eye: ``levels`` is ((H, W), count)
    a pyramid level, ``n`` the keypoints. Bytes: the level images, the
    keypoints, the angle and the bf16 descriptor out; operations a keypoint:
    the blur (40x32 + 32x32 outputs of 7 taps), its two bf16 roundings, the
    moments and the 256 bit tests."""
    n_bytes = sum(h * w * 4 for (h, w), _ in levels) + n * 8 + n * (4 + 256 * 2)
    per_kp = (40 * 32 + 32 * 32) * 13 + (40 * 40 + 32 * 32) + 4 * 1024 + 256
    return n_bytes, n * per_kp


def k1_bound_s(levels, n: int) -> float:
    return bound_s(*k1_bytes_ops(levels, n), "f32")


def k2_bytes(na: int, nb: int, mode: int) -> int:
    """K2, the gated Hamming top-2 of ``na`` rows against ``nb`` columns:
    packed descriptors, validity, positions (gated modes), levels (stereo),
    the gate, and the four outputs."""
    per_row = 32 + 1 + (8 if mode else 0) + (4 if mode == GATE_STEREO else 0)
    return (na + nb) * per_row + (8 if mode else 0) + 3 * 4 * na + 4 * nb


def k2_bound_s(na: int, nb: int, mode: int) -> float:
    """The distance product is a +-1 product of 256 terms a pair, counted as
    int8 operations (2 a term)."""
    return bound_s(k2_bytes(na, nb, mode), 2 * na * nb * 256, "int8")


def k3_bound_s(h: int, w: int, sweeps: int) -> float:
    """K3, ``sweeps`` Jacobi min-plus sweeps of an (h, w) grid: the start
    potential, the step costs and the output (4 bytes each) and the mask
    (1); 5 float32 operations a cell and sweep."""
    return bound_s(h * w * 13, 5 * h * w * sweeps, "f32")
