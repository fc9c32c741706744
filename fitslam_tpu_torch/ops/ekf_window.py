"""The EKF window kernel: a filter's whole window of packed measurement rows
fused in one launch of the hand-written CUDA kernel ``csrc/ekf_window.cu``.

The reference has no kernel for the filter: it scans a window's rows in one
``lax.scan`` (``fitslam_tpu/models/localization.py``, ``_run_ekf``), whose
plain port is ``models/localization.run_ekf``. ``ekf_window`` launches the
kernel on CUDA tensors (every row in order inside one thread block, state
and covariance in shared memory) and runs ``run_ekf`` on CPU tensors; it is
what ``localization.window_region``, the region ``DualEkf`` captures, calls.
"""

from __future__ import annotations

import ctypes

import torch

from fitslam_tpu_torch.utils.cuda_build import check_cuda_error, load_kernel_library

#: state dims (localization.STATE_DIM)
STATE_DIM = 15
#: packed row width of ``localization.rows_array``: dt, z, mask, var, gate
ROW_WIDTH = 3 * STATE_DIM + 2
#: rows a window may hold: ``DualEkf.WINDOW_CAP``, its one caller's window
#: (``csrc/ekf_window.cu``'s kMaxRows)
MAX_ROWS = 64


def _check(state, rows: torch.Tensor, Q: torch.Tensor) -> None:
    if rows.dim() != 2 or rows.shape[1] != ROW_WIDTH:
        raise ValueError(f"ekf_window: rows must be (T, {ROW_WIDTH}), got {tuple(rows.shape)}")
    if not 1 <= rows.shape[0] <= MAX_ROWS:
        raise ValueError(f"ekf_window: {rows.shape[0]} rows, expected 1 to {MAX_ROWS}")
    shapes = {"x": (state.x, (STATE_DIM,)), "P": (state.P, (STATE_DIM, STATE_DIM)),
              "Q": (Q, (STATE_DIM, STATE_DIM)), "rows": (rows, tuple(rows.shape))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"ekf_window: {name} must be a contiguous float32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != rows.device:
            raise ValueError(f"ekf_window: {name} on {t.device}, rows on {rows.device}")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ekf_window: unsupported device {rows.device}")


def ekf_window(state, rows: torch.Tensor, Q: torch.Tensor):
    """Fuse a window of packed rows (``rows_array``'s (T, 47) float32 layout,
    1 <= T <= ``MAX_ROWS``) into ``state`` (an ``EkfState``) in place and
    return it. On CUDA tensors one launch of ``csrc/ekf_window.cu`` runs
    every row in order; on CPU tensors its plain twin ``run_ekf`` runs and
    its final state is copied into ``state``. Raises ``ValueError`` on any
    other input."""
    _check(state, rows, Q)
    if rows.device.type == "cpu":
        from fitslam_tpu_torch.models import localization as loc

        new, _ = loc.run_ekf(state, loc.batch_from_array(rows), Q)
        state.x.copy_(new.x)
        state.P.copy_(new.P)
        return state
    fn = load_kernel_library("ekf_window").fitslam_ekf_window
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = fn(state.x.data_ptr(), state.P.data_ptr(), Q.data_ptr(), rows.data_ptr(),
                 rows.shape[0], stream)
    check_cuda_error(err, "ekf_window")
    ekf_window.launches += 1
    return state


#: ekf_window calls on CUDA tensors since the count was last reset (one a
#: window)
ekf_window.launches = 0
