"""ctypes bindings for the native host runtime (port of
``fitslam_tpu/runtime/native.py``, over the port's own ``csrc/runtime.cc``).

The host-side hot pieces stay native: the SPSC frame ring (the in-process
topic analog), the prefetching image-sequence reader (the camera-driver /
rosbag analog that feeds the ORB frontend) and a ns-resolution event logger
with CSV export. Python is the orchestration layer; these never hold the GIL
across IO.

The library is built by g++ at first use into ``build/native/`` at the
repository root (``utils/cuda_build.build_host_library``). A build that
fails raises with g++'s output: no path reads frames in Python instead.
Every frame a reader returns is a fresh array, so a prefetching thread never
writes under a host->device copy that is still pending.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from fitslam_tpu_torch.utils.cuda_build import build_host_library

_lib: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """The native runtime, built on first use; raises RuntimeError with the
    compiler's output when the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    path, _ = build_host_library()
    lib = ctypes.CDLL(str(path))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.fit_now_ns.restype = ctypes.c_int64
    lib.fit_now_ns.argtypes = []
    lib.fit_ring_create.restype = ctypes.c_void_p
    lib.fit_ring_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.fit_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.fit_ring_size.restype = ctypes.c_size_t
    lib.fit_ring_size.argtypes = [ctypes.c_void_p]
    lib.fit_ring_push.restype = ctypes.c_int
    lib.fit_ring_push.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    lib.fit_ring_pop.restype = ctypes.c_int
    lib.fit_ring_pop.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    lib.fit_seqreader_open.restype = ctypes.c_void_p
    lib.fit_seqreader_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.fit_seqreader_width.restype = ctypes.c_int
    lib.fit_seqreader_width.argtypes = [ctypes.c_void_p]
    lib.fit_seqreader_height.restype = ctypes.c_int
    lib.fit_seqreader_height.argtypes = [ctypes.c_void_p]
    lib.fit_seqreader_count.restype = ctypes.c_int64
    lib.fit_seqreader_count.argtypes = [ctypes.c_void_p]
    lib.fit_seqreader_next.restype = ctypes.c_int
    lib.fit_seqreader_next.argtypes = [
        ctypes.c_void_p, u8p, ctypes.c_size_t, ctypes.c_int64,
    ]
    lib.fit_seqreader_close.argtypes = [ctypes.c_void_p]
    lib.fit_eventlog_create.restype = ctypes.c_void_p
    lib.fit_eventlog_create.argtypes = []
    lib.fit_eventlog_destroy.argtypes = [ctypes.c_void_p]
    lib.fit_eventlog_begin.restype = ctypes.c_int64
    lib.fit_eventlog_begin.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.fit_eventlog_end.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.fit_eventlog_count.restype = ctypes.c_int64
    lib.fit_eventlog_count.argtypes = [ctypes.c_void_p]
    lib.fit_eventlog_export_csv.restype = ctypes.c_int64
    lib.fit_eventlog_export_csv.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    _lib = lib
    return _lib


def now_ns() -> int:
    return int(load_library().fit_now_ns())


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class SpscRing:
    """Lock-free single-producer single-consumer byte-slot ring."""

    def __init__(self, slot_size: int, n_slots: int):
        self._lib = load_library()
        self.slot_size = slot_size
        self._h = ctypes.c_void_p(self._lib.fit_ring_create(slot_size, n_slots))

    def push(self, data: np.ndarray) -> bool:
        buf = np.ascontiguousarray(data.reshape(-1).view(np.uint8))
        return bool(self._lib.fit_ring_push(self._h, _as_u8p(buf), buf.size))

    def pop(self) -> Optional[np.ndarray]:
        out = np.empty(self.slot_size, np.uint8)
        ok = self._lib.fit_ring_pop(self._h, _as_u8p(out), out.size)
        return out if ok else None

    def __len__(self) -> int:
        return int(self._lib.fit_ring_size(self._h))

    def close(self):
        if self._h:
            self._lib.fit_ring_destroy(self._h)
            self._h = None


class PgmSequenceReader:
    """Prefetching reader over a directory of P5 .pgm frames (sorted by
    name); each frame comes back as a new (H, W) uint8 array."""

    def __init__(self, directory: str, prefetch: int = 8):
        self._lib = load_library()
        self._h = ctypes.c_void_p(
            self._lib.fit_seqreader_open(str(directory).encode(), prefetch)
        )
        if not self._h:
            raise FileNotFoundError(f"no .pgm sequence in {directory}")
        self.width = int(self._lib.fit_seqreader_width(self._h))
        self.height = int(self._lib.fit_seqreader_height(self._h))
        self.count = int(self._lib.fit_seqreader_count(self._h))
        self._consumed = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        out = np.empty(self.height * self.width, np.uint8)
        rc = self._lib.fit_seqreader_next(
            self._h, _as_u8p(out), out.size, self._consumed
        )
        if rc == 0:
            raise StopIteration
        if rc < 0:
            raise IOError("pgm sequence read error")
        self._consumed += 1
        return out.reshape(self.height, self.width)

    def close(self):
        if self._h:
            self._lib.fit_seqreader_close(self._h)
            self._h = None


class NativeEventLog:
    """ns-resolution begin/end event log with CSV export."""

    def __init__(self):
        self._lib = load_library()
        self._h = ctypes.c_void_p(self._lib.fit_eventlog_create())

    def begin(self, name: str) -> int:
        return int(self._lib.fit_eventlog_begin(self._h, name.encode()))

    def end(self, idx: int):
        self._lib.fit_eventlog_end(self._h, idx)

    def count(self) -> int:
        return int(self._lib.fit_eventlog_count(self._h))

    def export_csv(self, path: str) -> int:
        return int(self._lib.fit_eventlog_export_csv(self._h, str(path).encode()))

    def close(self):
        if self._h:
            self._lib.fit_eventlog_destroy(self._h)
            self._h = None


def write_pgm(path: str, img: np.ndarray) -> None:
    """Write an 8-bit grayscale image as binary PGM (test fixture/helper)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())
