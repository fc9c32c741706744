"""Captured programs: the port's counterpart of ``fitslam_tpu/utils/jit.py``.

The reference runs each step function as one compiled device program
(``vjit`` is ``jax.jit`` with a source-salted name; the salting serves a
remote compile cache and has no counterpart here). The port's counterpart
of the compile is a CUDA graph: a region of a step, a function of tensors
whose shapes the configuration fixes, is run eagerly once (the warm-up, as
jit's first call compiles), captured into a ``torch.cuda.CUDAGraph`` on its
second call and replayed from then on, one launch from the host for the
whole region. A region that rarely recurs is given ``eager`` calls: each
owner's first ``eager`` calls of it run as plain PyTorch on the current
stream, and it is captured at the next one, so an owner that calls it once
or twice pays no warm-up and no capture.

A region is ``fn(*args) -> (writes, out)``. ``writes`` lines up with
``args``: where it holds a tree, its leaves are copied into that argument's
leaves, in place, inside the region (the state the region updates); ``out``
is a tree of tensors, returned. Arguments owned by the region's ``Slot``
(its state buffers, and the outputs of its other regions) are read where
they lie; any other argument is copied into a static input buffer first.
Outputs are packed into one byte buffer per region and returned as typed
views of it, so ``Slot.snapshot`` keeps a copy that a later replay does not
overwrite in one device copy, and ``to_host`` reads a region's outputs in
one transfer.

On a CPU tensor the function runs eagerly at every call, but through the
same static input, state and output buffers, so faults of aliasing show
there too. On CUDA a capture or replay error raises; nothing falls back to
eager. A region is never entered from inside another region's function (or
while the stream is being captured): that raises on either device. Launch
counters of the kernel wrappers (``.launches``), bumped in Python, move
only while a region is captured: the change seen then is added again at
every replay, so they count as the eager path does.

Every call of a region is a span of ``utils/profiling.RECORDER`` of its kind
(``replay``: one graph launch from the host, with the static inputs' copies;
``eager``, ``warm_up``, ``capture``) and bumps the recorder's counters,
which outlive the slots and ``release_idle``: ``RECORDER.captures`` counts
every capture of the process.

Slots are cached by key (device and the static settings: every argument of
the configuration that shapes the regions). An owner claims a slot; a slot
whose owner is gone is taken by the next owner of the same key, so a fresh
engine of a configuration already seen captures nothing new, while two live
owners never share one. Idle slots of other keys are freed when a new slot
is made (``release_idle`` frees them all).
"""

from __future__ import annotations

import gc
import time
import weakref
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from fitslam_tpu_torch.utils import profiling

_ALIGN = 16


# ---------------------------------------------------------------------------
# Trees of tensors (tuples, NamedTuples, lists; None is a constant leaf)
# ---------------------------------------------------------------------------


def flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """(tensor leaves in order, a spec that ``unflatten`` rebuilds from)."""
    leaves: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return None
        if x is None:
            return "none"
        if isinstance(x, (tuple, list)):
            return (type(x), tuple(walk(v) for v in x))
        raise TypeError(f"a captured region takes trees of tensors, got {type(x).__name__}")

    return leaves, walk(tree)


def unflatten(spec, leaves: Sequence[torch.Tensor]):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        if s == "none":
            return None
        kind, kids = s
        vals = [build(k) for k in kids]
        if kind is tuple or kind is list:
            return kind(vals)
        return kind(*vals)                       # a NamedTuple

    return build(spec)


def clone(tree):
    """A copy of every leaf of ``tree``."""
    leaves, spec = flatten(tree)
    return unflatten(spec, [x.clone() for x in leaves])


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.dtype == b.dtype
                      and a.shape == b.shape and a.stride() == b.stride())


def _check_like(dst: torch.Tensor, src: torch.Tensor, what: str):
    if dst.shape != src.shape or dst.dtype != src.dtype or dst.device != src.device:
        raise ValueError(f"{what}: expected {tuple(dst.shape)} {dst.dtype} on {dst.device}, "
                         f"got {tuple(src.shape)} {src.dtype} on {src.device}")


def assign(dst, src) -> None:
    """Copy the leaves of tree ``src`` into those of ``dst`` in place
    (shapes and types must agree). A leaf that is already its destination is
    skipped; a source that is itself one of the destinations is read before
    any destination is written."""
    d_leaves, _ = flatten(dst)
    s_leaves, _ = flatten(src)
    if len(d_leaves) != len(s_leaves):
        raise ValueError(f"assign: {len(s_leaves)} leaves into {len(d_leaves)}")
    dst_storages = {_storage(d) for d in d_leaves}
    pairs = []
    for d, s in zip(d_leaves, s_leaves):
        _check_like(d, s, "assign")
        if _same(d, s):
            continue
        if _storage(s) in dst_storages:
            s = s.clone()
        pairs.append((d, s))
    for d, s in pairs:
        d.copy_(s)


class Layout(NamedTuple):
    spec: Any
    fields: Tuple[Tuple[int, torch.dtype, torch.Size], ...]   # (byte offset, dtype, shape)
    nbytes: int


def layout_of(tree) -> Layout:
    leaves, spec = flatten(tree)
    fields, off = [], 0
    for x in leaves:
        fields.append((off, x.dtype, x.shape))
        off += -(-x.numel() * x.element_size() // _ALIGN) * _ALIGN
    return Layout(spec, tuple(fields), max(off, _ALIGN))


def unpack(buf: torch.Tensor, layout: Layout):
    """The tree of typed views into the byte buffer ``buf``."""
    views = []
    for off, dtype, shape in layout.fields:
        n = shape.numel() * torch.empty((), dtype=dtype).element_size()
        views.append(buf[off:off + n].view(dtype).reshape(shape))
    return unflatten(layout.spec, views)


def pack(tree, layout: Optional[Layout] = None, device=None) -> Tuple[torch.Tensor, Any]:
    """(a byte buffer holding the leaves of ``tree``, the tree of views into
    it). One copy a leaf."""
    layout = layout or layout_of(tree)
    leaves, _ = flatten(tree)
    dev = device if device is not None else (leaves[0].device if leaves else "cpu")
    buf = torch.empty((layout.nbytes,), dtype=torch.uint8, device=dev)
    views = unpack(buf, layout)
    for v, x in zip(flatten(views)[0], leaves):
        v.copy_(x)
    return buf, views


def _packed_in(tree, bufs: Dict[int, torch.Tensor]) -> Optional[torch.Tensor]:
    """The one packed buffer of ``bufs`` that holds every leaf of ``tree``."""
    leaves, _ = flatten(tree)
    if not leaves:
        return None
    buf = bufs.get(_storage(leaves[0]))
    if buf is None or any(_storage(x) != _storage(buf) or not x.is_contiguous() for x in leaves):
        return None
    return buf


def _reviewed(tree, buf: torch.Tensor, new: torch.Tensor, start: int = 0):
    """The leaves of ``tree`` (views into ``buf``) as the same views into
    ``new``, a copy of ``buf`` from its byte ``start`` on."""
    leaves, spec = flatten(tree)
    base = buf.data_ptr() + start
    out = []
    for x in leaves:
        off = x.data_ptr() - base
        out.append(new[off:off + x.numel() * x.element_size()].view(x.dtype).reshape(x.shape))
    return unflatten(spec, out)


def _span_copy(tree, buf: torch.Tensor):
    """The leaves of ``tree`` (views into the packed ``buf``) in one device
    copy of the bytes that span them, not of the whole buffer (a frame's
    cloud beside its images)."""
    leaves, _ = flatten(tree)
    base = buf.data_ptr()
    start = min(x.data_ptr() - base for x in leaves) // _ALIGN * _ALIGN
    end = max(x.data_ptr() - base + x.numel() * x.element_size() for x in leaves)
    return _reviewed(tree, buf, buf[start:end].clone(), start)


def to_host(tree, bufs: Optional[Dict[int, torch.Tensor]] = None):
    """``tree`` on the CPU in one device->host transfer (one wait): the
    packed buffer that holds it when there is one, else the leaves packed on
    the device first."""
    leaves, _ = flatten(tree)
    if not leaves or leaves[0].device.type == "cpu":
        return tree
    buf = _packed_in(tree, bufs or {})
    if buf is None:
        buf, tree = pack(tree)
    return _reviewed(tree, buf, buf.cpu())


# ---------------------------------------------------------------------------
# Launch counters of the kernel wrappers
# ---------------------------------------------------------------------------


def _counters():
    """The kernel wrappers whose ``launches`` a captured region must keep
    counting at replay (looked up by module attribute, where callers read
    them)."""
    from fitslam_tpu_torch.ops import ekf_window, orb, pallas_grid, pallas_matching, pallas_patches

    return ((orb, "describe_keypoints"), (pallas_matching, "hamming_top2"),
            (pallas_patches, "gather_patches"), (pallas_grid, "wavefront_sweeps"),
            (ekf_window, "ekf_window"))


def _read_counts() -> Tuple[int, ...]:
    return tuple(getattr(mod, name).launches for mod, name in _counters())


def _add_counts(delta: Sequence[int]) -> None:
    for (mod, name), d in zip(_counters(), delta):
        if d:
            getattr(mod, name).launches += d


def _set_counts(values: Sequence[int]) -> None:
    for (mod, name), v in zip(_counters(), values):
        getattr(mod, name).launches = v


class record_launches:
    """Around a capture: ``delta`` is the change of every counter inside
    the block, which is then undone (the replays count those launches)."""

    def __enter__(self):
        self.before = _read_counts()
        self.delta: Tuple[int, ...] = ()
        return self

    def __exit__(self, *exc):
        self.delta = tuple(b - a for a, b in zip(self.before, _read_counts()))
        _set_counts(self.before)
        return False


@contextmanager
def _setup_sync():
    """A device synchronisation of set-up (a capture, freeing a slot), not
    of a step: torch's sync debug mode, which callers use to count a step's
    syncs, is off around it."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


# ---------------------------------------------------------------------------
# One region
# ---------------------------------------------------------------------------


_RUNNING: List[str] = []      # the regions being called, innermost last


def _check_not_nested(name: str, device: torch.device) -> None:
    """Raise where region ``name`` would run inside another region's
    function or inside a stream capture: its graph would be captured into
    the other one, or its replay launched from inside a capture."""
    if _RUNNING:
        raise RuntimeError(f"region {name} entered inside region {_RUNNING[-1]}: regions do "
                           "not nest (run the inner solver with capture=False)")
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"region {name} entered while the stream is being captured")


def _run_region(fn, args):
    """``fn(*args)`` with its writes applied to ``args`` in place. Returns
    (positions written, out); an output that aliases an argument is cloned,
    so a later write cannot change it."""
    writes, out = fn(*args)
    writes = tuple(writes) + (None,) * (len(args) - len(writes))
    written = tuple(i for i, w in enumerate(writes) if w is not None)
    if written:
        assign(tuple(args[i] for i in written), tuple(writes[i] for i in written))
    in_storages = {_storage(x) for x in flatten(args)[0]}
    leaves, spec = flatten(out)
    leaves = [x.clone() if _storage(x) in in_storages else x for x in leaves]
    return written, unflatten(spec, leaves)


class CapturedStep:
    """One region of a step, owned by a ``Slot``: eager on its first call
    (on a side stream on CUDA), captured on its second, replayed after; on
    the CPU eager at every call through the same buffers. With ``eager``
    calls, each owner's first ``eager`` calls before the capture run as
    plain PyTorch on the current stream, and the next one captures."""

    def __init__(self, fn: Callable, name: str, slot: "Slot"):
        self.fn = fn
        self.name = name
        self.slot = slot
        self.calls = 0
        self.eager = 0                # an owner's calls run eagerly before the capture
        self._owner: Optional[weakref.ref] = None
        self._owner_calls = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_in: Optional[List[torch.Tensor]] = None
        self.in_spec = None
        self.written: Tuple[int, ...] = ()
        self.layout: Optional[Layout] = None
        self.out_buf: Optional[torch.Tensor] = None
        self.out = None
        self.launch_delta: Tuple[int, ...] = ()
        self.capture_s: Optional[float] = None     # seconds the capture took
        self.pool_bytes: Optional[int] = None      # device memory the graph's pool reserved

    # -- inputs --------------------------------------------------------
    def _bind(self, args) -> None:
        """Static inputs: the slot's own tensors where given, else copies."""
        leaves, self.in_spec = flatten(args)
        self.static_in = [x if self.slot.owns(x) else x.clone() for x in leaves]

    def _load(self, args):
        leaves, spec = flatten(args)
        if spec != self.in_spec or len(leaves) != len(self.static_in):
            raise ValueError(f"region {self.name}: arguments changed structure")
        for s, x in zip(self.static_in, leaves):
            if not _same(s, x):
                _check_like(s, x, f"region {self.name}")
                s.copy_(x)
        return unflatten(self.in_spec, self.static_in)

    def _result(self, args):
        static = unflatten(self.in_spec, self.static_in)
        new_args = tuple(static[i] if i in self.written else a for i, a in enumerate(args))
        return new_args, self.out

    # -- the kinds of call ------------------------------------------------
    def eager_now(self) -> bool:
        """Whether this call, of the slot's current owner, runs eagerly
        before the capture (its first ``eager`` calls while none is captured)."""
        if self.slot._owner is not self._owner:
            self._owner, self._owner_calls = self.slot._owner, 0
        self._owner_calls += 1
        return self.graph is None and self._owner_calls <= self.eager

    def __call__(self, *args):
        dev = self.slot.device
        _check_not_nested(self.name, dev)
        _RUNNING.append(self.name)
        try:
            return self._call(dev, args)
        finally:
            _RUNNING.pop()

    def _call(self, dev, args):
        if dev.type != "cuda":
            with profiling.span(self.name, "eager", dev):
                return self._eager_through_buffers(args)
        if self.eager_now():
            with profiling.span(self.name, "eager", dev):
                self.calls += 1
                self.written, out = _run_region(self.fn, args)
            return args, out
        if self.calls == 0:
            self.calls = 1
            with profiling.span(self.name, "warm_up", dev):
                return self._warm_up(args)
        if self.graph is None:
            with profiling.span(self.name, "capture", dev):
                self._capture(args)
            self.replay()
        else:
            with profiling.span(self.name, "replay", dev):
                self._load(args)
                self._replay()
        return self._result(args)

    def replay(self) -> None:
        """One replay of the captured graph, counted as its launches and as
        a ``replay`` span."""
        with profiling.span(self.name, "replay", self.slot.device):
            self._replay()

    def _replay(self) -> None:
        self.calls += 1
        self.graph.replay()
        _add_counts(self.launch_delta)

    def _eager_through_buffers(self, args):
        if self.static_in is None:
            self._bind(args)
        static_args = self._load(args)
        self.written, out = _run_region(self.fn, static_args)
        if self.out_buf is None:
            self.layout = layout_of(out)
            self.out_buf, self.out = pack(out, self.layout, self.slot.device)
            self.slot.register(self.out_buf, packed=True)
        else:
            assign(self.out, out)
        self.calls += 1
        return self._result(args)

    def _warm_up(self, args):
        cur = torch.cuda.current_stream(self.slot.device)
        side = self.slot.side_stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.written, out = _run_region(self.fn, args)
        cur.wait_stream(side)
        for x in flatten(out)[0]:
            x.record_stream(cur)
        return args, out

    def _capture(self, args) -> None:
        with _setup_sync():
            self._capture_synced(args)

    def _capture_synced(self, args) -> None:
        """The capture, after a device synchronisation and with the device's
        cache emptied (``torch.cuda.graph`` empties it on entry too), so the
        growth of the reserved memory is the graph's pool. The cyclic garbage
        collector is paused during it, not run before it: a collection inside
        a capture that frees a CUDA object (an event, pinned memory)
        invalidates the capture, and a full collection before each one cost
        a small region's capture ~100 host ms in a large process."""
        dev = self.slot.device
        self._bind(args)
        static_args = unflatten(self.in_spec, self.static_in)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        g = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with record_launches() as launches, \
                    torch.cuda.graph(g, capture_error_mode="thread_local"):
                self.written, out = _run_region(self.fn, static_args)
                self.layout = layout_of(out)
                self.out_buf, self.out = pack(out, self.layout, self.slot.device)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved0
        self.launch_delta = launches.delta
        self.graph = g
        self.slot.register(self.out_buf, packed=True)


# ---------------------------------------------------------------------------
# Slots: one owner's regions and state buffers, cached by key
# ---------------------------------------------------------------------------


class Slot:
    """The captured regions of one owner at a time, and the buffers its
    state lives in. ``state`` is a dict of trees of tensors that become the
    buffers (owned by the slot, read in place by every region)."""

    def __init__(self, device, state: Dict[str, Any]):
        self.device = torch.device(device)
        self.buffers = dict(state)
        self.regions: Dict[str, CapturedStep] = {}
        self._owned: set = set()
        self._packed: Dict[int, torch.Tensor] = {}
        self._owner: Optional[weakref.ref] = None
        self._side: Optional[torch.cuda.Stream] = None
        for tree in self.buffers.values():
            for x in flatten(tree)[0]:
                self.register(x)

    @property
    def side_stream(self) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    @property
    def idle(self) -> bool:
        return self._owner is None or self._owner() is None

    def register(self, t: torch.Tensor, packed: bool = False) -> None:
        self._owned.add(_storage(t))
        if packed:
            self._packed[_storage(t)] = t

    def owns(self, t: torch.Tensor) -> bool:
        return _storage(t) in self._owned

    def run(self, name: str, fn: Callable, *args, eager: int = 0):
        """Region ``name`` of this slot on ``args`` (made from ``fn`` on its
        first use): returns (args with the region's writes, out). ``eager``:
        the calls of each owner that run as plain PyTorch before the region
        is captured (``CapturedStep``)."""
        region = self.regions.get(name)
        if region is None:
            region = self.regions[name] = CapturedStep(fn, name, self)
        region.eager = eager
        return region(*args)

    def snapshot(self, tree):
        """A copy of ``tree`` that later calls of the regions leave alone:
        one device copy (of the bytes that span it) when a region's packed
        outputs hold it."""
        buf = _packed_in(tree, self._packed)
        if buf is None:
            return clone(tree)
        return _span_copy(tree, buf)

    def to_host(self, tree):
        return to_host(tree, self._packed)

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """{region: calls, whether captured, capture seconds, pool bytes}."""
        return {name: {"calls": r.calls, "captured": r.graph is not None,
                       "capture_s": r.capture_s, "pool_bytes": r.pool_bytes}
                for name, r in self.regions.items()}


_SLOTS: Dict[Any, List[Slot]] = {}


def claim(owner, key, device, make_state: Callable[[], Dict[str, Any]]) -> Tuple[Slot, bool]:
    """A slot of ``key`` for ``owner``: an idle one when there is one (its
    buffers then hold the last owner's state: the caller assigns its own),
    else a new one whose buffers are ``make_state()``. Returns (slot, new)."""
    dev = torch.device(device)
    key = (str(dev), key)
    for attempt in (0, 1):
        for slot in _SLOTS.get(key, []):
            if slot.idle:
                slot._owner = weakref.ref(owner)
                return slot, False
        if attempt == 0 and key in _SLOTS:
            gc.collect()                 # owners dead in a reference cycle
    _drop_idle(keep=key)
    slot = Slot(dev, make_state())
    slot._owner = weakref.ref(owner)
    _SLOTS.setdefault(key, []).append(slot)
    return slot, True


class SlotState:
    """The state of one owner of regions (name -> tree of tensors) and the
    slot it moves into: the owner's own tensors until its first region call
    claims a slot of ``key`` (a new slot's buffers are copies of them, an idle
    slot's buffers get them assigned), the slot's buffers from then on.
    Assigning a field then copies into its buffer, so the next call of a
    region reads it; the fields named in ``fresh`` are handed out as a new
    view after each assignment (for readers that cache on a tensor's
    identity). Without ``capture`` no slot is claimed: the regions run as
    plain PyTorch (``run_eagerly``) and assigning a field replaces it."""

    def __init__(self, owner, key, device, state: Dict[str, Any], capture: bool = True,
                 fresh: Sequence[str] = ()):
        self._owner = weakref.ref(owner)
        self.key = key
        self.device = torch.device(device)
        self.capture = capture
        self.fresh = frozenset(fresh)
        self.trees = dict(state)
        self.slot: Optional[Slot] = None

    def claim(self) -> Slot:
        if self.slot is None:
            trees = self.trees
            slot, new = claim(self._owner(), self.key, self.device,
                              lambda: {name: clone(tree) for name, tree in trees.items()})
            if not new:
                for name, tree in trees.items():
                    assign(slot.buffers[name], tree)
            self.slot = slot
            self.trees = dict(slot.buffers)
        return self.slot

    def __getitem__(self, name: str):
        return self.trees[name]

    def __setitem__(self, name: str, value) -> None:
        if self.slot is None:
            self.trees[name] = value
            return
        buf = self.slot.buffers[name]
        assign(buf, value)
        self.trees[name] = buf.view_as(buf) if name in self.fresh else buf

    def fill(self, name: str, value) -> torch.Tensor:
        """Field ``name``, a device scalar that regions read, set to
        ``value`` in place (the slot's buffer when capturing)."""
        if self.capture:
            self.claim()
        return self.trees[name].fill_(value)

    def run(self, name: str, fn: Callable, *args, eager: int = 0):
        """Region ``name`` on ``args``: ``Slot.run`` when capturing, else
        ``run_eagerly``."""
        if not self.capture:
            return run_eagerly(name, fn, *args)
        return self.claim().run(name, fn, *args, eager=eager)

    def snapshot(self, tree):
        """``Slot.snapshot`` of the claimed slot: a copy that later region
        calls leave alone. Without a slot (``run_eagerly``'s fresh tensors)
        the tree itself."""
        return self.slot.snapshot(tree) if self.slot is not None else tree

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """``Slot.stats`` of the claimed slot; empty before or without one."""
        return self.slot.stats() if self.slot is not None else {}


class slot_field:
    """An owner's attribute that is a field of its ``SlotState`` (the
    owner's ``_slot_state``): reading gives the tree, assigning goes through
    ``SlotState.__setitem__``."""

    def __init__(self, name: Optional[str] = None, doc: Optional[str] = None):
        self.name = name
        self.__doc__ = doc

    def __set_name__(self, cls, attr: str) -> None:
        self.name = self.name or attr

    def __get__(self, obj, cls=None):
        return self if obj is None else obj._slot_state[self.name]

    def __set__(self, obj, value) -> None:
        obj._slot_state[self.name] = value


def _drop_idle(keep=None) -> None:
    idle = [(k, s) for k, slots in _SLOTS.items() for s in slots if s.idle and k != keep]
    if not idle:
        return
    for dev in {s.device for _, s in idle if s.device.type == "cuda"}:
        with _setup_sync():
            torch.cuda.synchronize(dev)  # no replay still reads a pool that goes
    for k, s in idle:
        _SLOTS[k].remove(s)
        if not _SLOTS[k]:
            del _SLOTS[k]


def release_idle() -> None:
    """Free every slot whose owner is gone (graphs, pools and buffers)."""
    gc.collect()
    _drop_idle()


def slots() -> List[Slot]:
    return [s for slots_ in _SLOTS.values() for s in slots_]


def hold(tree):
    """``tree`` kept across later calls of the regions that made it: when
    one region's packed outputs hold it (a rendered frame's cloud), the
    copy of ``Slot.snapshot``; any other tree (an eager run's fresh
    tensors) is returned as it is."""
    leaves, _ = flatten(tree)
    if leaves:
        for slot in slots():
            buf = _packed_in(tree, slot._packed)
            if buf is not None:
                return _span_copy(tree, buf)
    return tree


def run_eagerly(name: str, fn: Callable, *args):
    """A region run as plain PyTorch, the same ``(args with the writes, out)``
    as ``Slot.run`` without buffers: the writes replace the arguments."""
    writes, out = fn(*args)
    writes = tuple(writes) + (None,) * (len(args) - len(writes))
    return tuple(a if w is None else w for a, w in zip(args, writes)), out


def pure(fn: Callable) -> Callable:
    """``fn(*args) -> out`` as a region that writes nothing."""
    return lambda *args: ((), fn(*args))
