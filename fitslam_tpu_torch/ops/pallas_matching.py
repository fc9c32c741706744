"""K2, the gated Hamming top-2 matcher (port of
``fitslam_tpu/ops/pallas_matching.py``; the module keeps the reference's name
so the pair maps file to file).

``hamming_top2`` launches the hand-written CUDA kernel ``csrc/hamming_top2.cu``
on CUDA tensors and runs ``hamming_top2_plain``, its plain PyTorch twin, on
CPU tensors. On the port's main path K2 carries ``matching.match_stereo`` and
``matching.match_windowed``, and ``match_ratio_fused`` for loop verification
and relocalization (``models/loop_closing.verify_loop``); the reference left
those to XLA's fused matmul and kept its Pallas kernel for parity tests.

Differences from the reference kernel's outputs: distances are int32 and the
"no candidate" sentinel is 512 (the reference kernel uses 1e6), which is the
sentinel ``matching.match_ratio`` clips to, so selection outcomes agree.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from fitslam_tpu_torch.utils.cuda_build import check_cuda_error, load_kernel_library

SENTINEL = 512
GATE_NONE, GATE_WINDOW, GATE_STEREO = 0, 1, 2
WORDS = 8   # 256-bit descriptors as 8 x uint32


class Top2(NamedTuple):
    idx: torch.Tensor       # (Na,) int32 best column per row (0 if no candidate)
    best: torch.Tensor      # (Na,) int32 best distance, <= 512
    second: torch.Tensor    # (Na,) int32 second-best distance, <= 512
    col_best: torch.Tensor  # (Nb,) int32 best row per column (lowest row on ties)


def _unpack_pm1(bits: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 packed -> (N, 256) float32 in {-1, +1}."""
    shifts = torch.arange(32, device=bits.device)
    b = (bits.long()[:, :, None] >> shifts) & 1
    return b.reshape(bits.shape[0], WORDS * 32).float() * 2.0 - 1.0


def _gate_mask(mode, xy_a, xy_b, level_a, level_b, gate):
    if mode == GATE_WINDOW:
        d2 = torch.sum((xy_a[:, None, :] - xy_b[None, :, :]) ** 2, dim=-1)
        return d2 <= gate[0]
    if mode == GATE_STEREO:
        dv = torch.abs(xy_a[:, None, 1] - xy_b[None, :, 1])
        disp = xy_a[:, None, 0] - xy_b[None, :, 0]
        lvl_ok = torch.abs(level_a[:, None] - level_b[None, :]) <= 1
        return (dv <= gate[0]) & (disp > 0.1) & (disp < gate[1]) & lvl_ok
    return None


def hamming_top2_plain(a_bits, valid_a, b_bits, valid_b, mode=GATE_NONE,
                       xy_a=None, xy_b=None, level_a=None, level_b=None,
                       gate=None, col_chunk: Optional[int] = None) -> Top2:
    """Plain PyTorch twin of the K2 kernel (same arguments and outputs).

    ``col_chunk`` mirrors the kernel's column split: the rows' top-2 is taken
    over each chunk of ``col_chunk`` columns and the chunks are merged in
    order with the kernel's rule, best = min and second = min(seconds,
    max(bests)) on (distance, column) keys. The result does not depend on
    the chunk size."""
    na, nb = a_bits.shape[0], b_bits.shape[0]
    dot = _unpack_pm1(a_bits) @ _unpack_pm1(b_bits).T
    d = ((WORDS * 32 - dot) * 0.5).long()
    ok = valid_a[:, None] & valid_b[None, :]
    g = _gate_mask(mode, xy_a, xy_b, level_a, level_b, gate)
    if g is not None:
        ok = ok & g
    d = torch.where(ok, torch.clamp(d, max=SENTINEL), SENTINEL)
    cols = torch.arange(nb, device=d.device)
    packed = d * nb + cols[None, :]
    best = second = None
    for c0 in range(0, nb, col_chunk or nb):
        chunk = packed[:, c0:c0 + (col_chunk or nb)]
        p1 = chunk.min(dim=1).values
        # the chunk's second key: its minimum once the best column is masked
        # (a chunk of one column has none: SENTINEL at the largest column)
        p2 = torch.where(chunk == p1[:, None], SENTINEL * nb + nb - 1, chunk).min(dim=1).values
        if best is None:
            best, second = p1, p2
        else:
            best, second = (torch.minimum(best, p1),
                            torch.minimum(torch.minimum(second, p2), torch.maximum(best, p1)))
    rows = torch.arange(na, device=d.device)
    col_best = (d * na + rows[:, None]).min(dim=0).values % na
    return Top2((best % nb).int(), (best // nb).int(), (second // nb).int(), col_best.int())


def _check(a_bits, valid_a, b_bits, valid_b, mode, xy_a, xy_b, level_a, level_b, gate):
    dev = a_bits.device
    for name, t, shape, dtype in (
        ("a_bits", a_bits, (None, WORDS), torch.int32),
        ("valid_a", valid_a, (a_bits.shape[0],), torch.bool),
        ("b_bits", b_bits, (None, WORDS), torch.int32),
        ("valid_b", valid_b, (b_bits.shape[0],), torch.bool),
    ):
        if (t.dim() != len(shape) or any(s is not None and s != ts for s, ts in zip(shape, t.shape))
                or t.dtype != dtype or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name}: expected contiguous {dtype} of shape {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    na, nb = a_bits.shape[0], b_bits.shape[0]
    if na < 1 or nb < 1:
        raise ValueError("hamming_top2 needs at least one row and one column")
    if mode not in (GATE_NONE, GATE_WINDOW, GATE_STEREO):
        raise ValueError(f"unknown gate mode {mode}")
    if mode != GATE_NONE:
        for name, t, n in (("xy_a", xy_a, na), ("xy_b", xy_b, nb)):
            if (t is None or tuple(t.shape) != (n, 2) or t.dtype != torch.float32
                    or not t.is_contiguous() or t.device != dev):
                raise ValueError(f"{name}: expected contiguous float32 ({n}, 2) on {dev}")
        if (gate is None or tuple(gate.shape) != (2,) or gate.dtype != torch.float32
                or gate.device != dev or not gate.is_contiguous()):
            raise ValueError(f"gate: expected contiguous float32 (2,) on {dev}")
    if mode == GATE_STEREO:
        for name, t, n in (("level_a", level_a, na), ("level_b", level_b, nb)):
            if (t is None or tuple(t.shape) != (n,) or t.dtype != torch.int32
                    or not t.is_contiguous() or t.device != dev):
                raise ValueError(f"{name}: expected contiguous int32 ({n},) on {dev}")
    if max(na, nb) + 64 > 2 ** 22:
        raise ValueError("hamming_top2 keys hold row and column indices below 2**22")


#: distance-product designs of csrc/hamming_top2.cu, by the number its C
#: entry takes: the single-bit tensor-core product (the default, faster at
#: both main-path shapes) and the +-1 int8 one, kept so that the two are timed
#: side by side (chip_smoke.py phase 3)
DESIGNS = {"b1": 0, "s8": 1}
DEFAULT_DESIGN = "b1"
KEY_SHIFT = 22   # keys are (distance << 22) | index


class Top2Plan(NamedTuple):
    cols_per_block: int   # a multiple of 32: 4 warps of 8-column tiles
    splits: int           # blocks across the columns


BLOCKS_PER_SM = 4   # the column split's target, as timed at both main-path shapes


def top2_plan(na: int, nb: int, sms: int, blocks_per_sm: int = BLOCKS_PER_SM) -> Top2Plan:
    """Column split of the tensor-core designs: 64 rows a block, and enough
    column splits that about ``blocks_per_sm`` blocks run on each of ``sms``
    SMs."""
    row_blocks = -(-na // 64)
    splits = max(1, min(-(-nb // 32), -(-blocks_per_sm * sms // row_blocks)))
    cols = -(-nb // splits)
    cols = -(-cols // 32) * 32
    return Top2Plan(cols, -(-nb // cols))


def hamming_top2(a_bits: torch.Tensor, valid_a: torch.Tensor, b_bits: torch.Tensor,
                 valid_b: torch.Tensor, mode: int = GATE_NONE,
                 xy_a: Optional[torch.Tensor] = None, xy_b: Optional[torch.Tensor] = None,
                 level_a: Optional[torch.Tensor] = None, level_b: Optional[torch.Tensor] = None,
                 gate: Optional[torch.Tensor] = None, design: str = DEFAULT_DESIGN,
                 plan: Optional[Top2Plan] = None) -> Top2:
    """Gated top-2 of packed-descriptor Hamming distances, rows of A against
    columns of B. ``gate`` is a float32 (2,) device tensor: [r^2, unused] for
    the window gate, [row tolerance, max disparity] for the stereo gate.
    ``design`` picks the kernel's distance product (``DESIGNS``) and
    ``plan`` overrides ``top2_plan``'s column split; all give the same
    outputs."""
    _check(a_bits, valid_a, b_bits, valid_b, mode, xy_a, xy_b, level_a, level_b, gate)
    dev = a_bits.device
    if dev.type == "cpu":
        return hamming_top2_plain(a_bits, valid_a, b_bits, valid_b, mode,
                                  xy_a, xy_b, level_a, level_b, gate)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if design not in DESIGNS:
        raise ValueError(f"unknown K2 design {design!r}, expected one of {sorted(DESIGNS)}")
    if a_bits.data_ptr() % 16 or b_bits.data_ptr() % 16:
        raise ValueError("packed descriptors must be 16-byte aligned")
    lib = load_kernel_library("hamming_top2")
    fn = lib.fitslam_hamming_top2
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    na, nb = a_bits.shape[0], b_bits.shape[0]
    plan = plan or top2_plan(na, nb, torch.cuda.get_device_properties(dev).multi_processor_count)
    if plan.cols_per_block % 32 or plan.cols_per_block * plan.splits < nb:
        raise ValueError(f"hamming_top2: {plan} does not cover {nb} columns in 32-column steps")
    idx = torch.empty((na,), dtype=torch.int32, device=dev)
    best = torch.empty_like(idx)
    second = torch.empty_like(idx)
    part = torch.empty((plan.splits, na, 2), dtype=torch.int32, device=dev)
    col_key = torch.full((nb,), -1, dtype=torch.int32, device=dev)   # 0xffffffff

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a_bits.data_ptr(), valid_a.data_ptr(), b_bits.data_ptr(), valid_b.data_ptr(),
                 na, nb, mode, ptr(xy_a), ptr(xy_b), ptr(level_a), ptr(level_b), ptr(gate),
                 DESIGNS[design], plan.cols_per_block, plan.splits, part.data_ptr(),
                 idx.data_ptr(), best.data_ptr(), second.data_ptr(), col_key.data_ptr(), stream)
    check_cuda_error(err, "hamming_top2")
    hamming_top2.launches += 1
    return Top2(idx, best, second, col_key & ((1 << KEY_SHIFT) - 1))


#: K2 calls on CUDA tensors since the count was last reset
hamming_top2.launches = 0


def match_ratio_fused(bits_a: torch.Tensor, valid_a: torch.Tensor, bits_b: torch.Tensor,
                      valid_b: torch.Tensor, max_distance: int = 64, ratio: float = 0.8,
                      mutual: bool = True):
    """``matching.match_ratio(hamming_matrix(...), ...)`` on K2 with no gate:
    the distance matrix never reaches memory. Descriptors are packed
    (``orb.pack_descriptors``). The mutual check keeps a row only where it is
    its best column's best row, read from K2's column argmin (lowest row on
    ties, as ``jnp.argmin`` over the reference's distance matrix). Returns
    ``matching.Matches``."""
    from fitslam_tpu_torch.ops.matching import Matches

    t = hamming_top2(bits_a, valid_a, bits_b, valid_b, GATE_NONE)
    ok = (t.best <= max_distance) & (t.best.float() < ratio * t.second.float())
    if mutual:
        rows = torch.arange(bits_a.shape[0], dtype=torch.int32, device=bits_a.device)
        ok = ok & (t.col_best[t.idx.long()] == rows)
    return Matches(t.idx, t.best, ok)
