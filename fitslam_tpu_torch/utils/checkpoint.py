"""Checkpoint / resume of the full SLAM + exploration state (port of
``fitslam_tpu/utils/checkpoint.py``).

The file format is the reference's, key for key, so a checkpoint that either
package writes, the other loads: one compressed npz of named groups of
arrays (``"<group>::<leaf path>"``) plus a JSON ``__meta__`` blob. Device
state is fixed-capacity NamedTuples of tensors, flattened by tree path into
the strings ``jax.tree_util.tree_flatten_with_path`` gives (``a/b/0``: field
names, sequence indices, dict keys) and restored into a template of the same
structure on the template's device and dtype (a missing leaf raises
``KeyError``, a shape mismatch ``ValueError``). bfloat16 is stored as its
uint16 bit view, as the reference stores it.

The port keeps one piece of host state the reference has not: the tracker's
``initialized`` mirror (``StereoSlam._track_initialized``, ROADMAP F10). It is
written as the extra ``meta`` key ``track_initialized``, which the reference
ignores; a file without it takes the value from the restored tracker state.
Constants uploaded once a device (ROADMAP F8: the describe tables, the
vocabulary, the Fisher-information table) are not state: nothing here saves
them or touches them. The loop closer's state is not saved, as in the
reference (ROADMAP F6).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from fitslam_tpu_torch.utils import profiling
from fitslam_tpu_torch.utils.transfer import upload


def _leaves_with_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(path string, leaf) in ``tree_flatten_with_path``'s order: NamedTuple
    fields, sequence items and dict keys (sorted) in turn; None has no leaf."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    else:
        return [("/".join(prefix), tree)]
    out = []
    for name, child in items:
        out += _leaves_with_paths(child, prefix + (name,))
    return out


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if template is None:
        return None
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*[_unflatten(getattr(template, f), leaves)
                                for f in template._fields])
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, leaves) for v in template)
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    return next(leaves)


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def pytree_to_arrays(tree) -> Dict[str, np.ndarray]:
    """Flatten a tree of tensors to {path: np.ndarray}; bfloat16 leaves as
    uint16 bit views (npz cannot hold bfloat16)."""
    return {path: _to_numpy(leaf) for path, leaf in _leaves_with_paths(tree)}


def _restore_leaf(key: str, arr: np.ndarray, want: torch.Tensor) -> torch.Tensor:
    if tuple(arr.shape) != tuple(want.shape):
        raise ValueError(f"checkpoint leaf '{key}' shape {arr.shape} != {tuple(want.shape)}")
    if want.dtype == torch.bfloat16:
        t = (torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
             if arr.dtype == np.uint16 else torch.from_numpy(arr.astype(np.float32)).bfloat16())
        return t.to(want.device)
    np_dtype = torch.empty((), dtype=want.dtype).numpy().dtype
    return upload(arr.astype(np_dtype), want.device)


def arrays_to_pytree(template, arrays: Dict[str, np.ndarray]):
    """Restore a tree structured like ``template`` from {path: array}, each
    leaf on the template leaf's device and in its dtype."""
    restored = []
    for key, leaf in _leaves_with_paths(template):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf '{key}'")
        restored.append(_restore_leaf(key, arrays[key], leaf))
    return _unflatten(template, iter(restored))


def save_arrays(path: str, groups: Dict[str, Dict[str, np.ndarray]],
                meta: Optional[Dict[str, Any]] = None):
    """Write named groups of arrays + a JSON meta blob into one npz."""
    flat = {f"{g}::{k}": v for g, arrays in groups.items() for k, v in arrays.items()}
    flat["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez_compressed(path, **flat)


def load_arrays(path: str):
    """Inverse of save_arrays -> (groups, meta)."""
    data = np.load(path, allow_pickle=False)
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    meta: Dict[str, Any] = {}
    for k in data.files:
        if k == "__meta__":
            meta = json.loads(bytes(data[k]).decode())
            continue
        g, leaf = k.split("::", 1)
        groups.setdefault(g, {})[leaf] = data[k]
    return groups, meta


# ---------------------------------------------------------------------------
# System-level checkpoints
# ---------------------------------------------------------------------------


def _trajectory_group(slam) -> Dict[str, np.ndarray]:
    return {"stack": np.stack(slam.trajectory) if slam.trajectory else np.zeros((0, 4, 4))}


def _restore_slam(slam, groups, meta) -> None:
    """The engine's map, tracker, trajectory and host counters from a file;
    the asynchronous path's buffers as ``finalize()`` leaves them."""
    slam.map = arrays_to_pytree(slam.map, groups["map"])
    slam.state = arrays_to_pytree(slam.state, groups["state"])
    slam.trajectory = [T for T in groups["trajectory"]["stack"]]
    slam.frame_id = int(meta["frame_id"])
    slam._initialized = bool(meta["initialized"])
    if "track_initialized" in meta:
        slam._track_initialized = bool(meta["track_initialized"])
    else:   # a reference file: read the restored tracker's flag
        with profiling.host_read("load_slam.initialized", slam.device):
            slam._track_initialized = bool(slam.state.initialized)
        slam.host_syncs += 1
    slam.outs_log, slam._outs_fids = [], []
    slam._polled_until, slam._poll_pending = 0, None
    slam._frame_ring.clear()


def save_slam(path: str, slam) -> None:
    """Checkpoint a StereoSlam: map + tracker + host counters + trajectory."""
    slam._materialize_loop_events()   # the loop records' device scalars as floats
    groups = {"map": pytree_to_arrays(slam.map), "state": pytree_to_arrays(slam.state),
              "trajectory": _trajectory_group(slam)}
    meta = {"kind": "slam", "frame_id": slam.frame_id, "initialized": slam._initialized,
            "loop_events": slam.loop_events, "track_initialized": slam._track_initialized}
    save_arrays(path, groups, meta)


def load_slam(path: str, slam) -> None:
    """Restore into an already-constructed StereoSlam of identical config."""
    groups, meta = load_arrays(path)
    if meta.get("kind") != "slam":
        raise ValueError(f"{path} is not a slam checkpoint")
    _restore_slam(slam, groups, meta)
    slam.loop_events = list(meta.get("loop_events", []))


def save_active_system(path: str, system) -> None:
    """Checkpoint an ActiveSlamSystem: SLAM + clouds + roadmap + exploration
    host state (goal, blacklist, diagnostics, overlay) and the EKF's.

    Drains the asynchronous frame path first: keyframe events (cloud
    association, loop closing) fire for every dispatched frame and the
    per-frame outputs are read into ``slam.trajectory``, so a restored
    mission keeps its full history. Per-frame clouds of frames that have not
    become keyframes are dropped (they would only ever join a future
    keyframe). Buffered EKF rows are folded in first, or sensor data received
    since the last flush would be missing from the file."""
    ex = system.explorer
    system.slam.poll_keyframe_events()
    system.slam.finalize()
    system._pending_cloud.clear()
    if system.ekf is not None:
        system.ekf.flush()
        system._ekf_dirty = False
    groups = {
        "map": pytree_to_arrays(system.slam.map),
        "state": pytree_to_arrays(system.slam.state),
        "clouds": pytree_to_arrays(system.clouds),
        "roadmap": pytree_to_arrays(ex.roadmap),
        "overlay": {"lethal": _to_numpy(ex.lethal_overlay),
                    "wedge_age": _to_numpy(ex.wedge_age)},
        "anchor": pytree_to_arrays(system.T_anchor) if system.T_anchor is not None else {},
        "trajectory": _trajectory_group(system.slam),
        "explore_np": {
            "blacklist": (np.stack([ex._circle3(c) for c in ex.blacklist_xy])
                          if ex.blacklist_xy else np.zeros((0, 3))),
            "trailing": np.stack(ex.trailing_poses) if ex.trailing_poses else np.zeros((0, 3)),
            "goal": np.asarray(ex._goal_xy) if ex._goal_xy is not None else np.zeros((0,)),
        },
    }
    if system.ekf is not None:
        groups["ekf_odom"] = pytree_to_arrays(system.ekf.odom_state)
        groups["ekf_map"] = pytree_to_arrays(system.ekf.map_state)
    meta = {
        "kind": "active_slam",
        "frame_id": system.slam.frame_id,
        "initialized": system.slam._initialized,
        "grid_dirty": system._grid_dirty,
        "state_enum": ex.state.value,
        "diag": vars(ex.diag),
        "search_radius": ex._search_radius,
        "goal_heading": ex._goal_heading,
        "goal_sent_tick": ex._goal_sent_tick,
        "goal_failures": {f"{k[0]},{k[1]}": v for k, v in ex._goal_failures.items()},
        "fi_exhaustive_retry": ex._fi_exhaustive_retry,
        "fi_retries": ex._fi_retries,
        "fi_drop_count": ex._fi_drop_count,
        "recovery_ticks_left": ex._recovery_ticks_left,
        "has_anchor": system.T_anchor is not None,
        "track_initialized": system.slam._track_initialized,
    }
    save_arrays(path, groups, meta)


def load_active_system(path: str, system) -> None:
    """Restore into an already-constructed ActiveSlamSystem of identical
    config. The grid is re-fused from the restored clouds at its first read
    (the running per-cell sums are not in the file)."""
    from fitslam_tpu_torch.models.exploration import ExplorationState
    from fitslam_tpu_torch.ops import lie

    groups, meta = load_arrays(path)
    if meta.get("kind") != "active_slam":
        raise ValueError(f"{path} is not an active_slam checkpoint")
    ex = system.explorer
    _restore_slam(system.slam, groups, meta)
    system.clouds = arrays_to_pytree(system.clouds, groups["clouds"])
    ex.roadmap = arrays_to_pytree(ex.roadmap, groups["roadmap"])
    ex.lethal_overlay = upload(groups["overlay"]["lethal"], system.device, torch.bool)
    if "wedge_age" in groups["overlay"]:   # older reference files lack it
        ex.wedge_age = upload(groups["overlay"]["wedge_age"], system.device, torch.int32)
    if meta["has_anchor"]:
        system.T_anchor = arrays_to_pytree(lie.SE3.identity(device=system.device),
                                           groups["anchor"])
        system._anchor_np = None   # the host mirror is rebuilt at its next use
    system._grid_dirty = True      # refuse stale grids: re-fuse on first read
    system._restitch = True        # running aggregates are not checkpointed
    system._ekf_pose_cache = None
    enp = groups["explore_np"]
    ex.blacklist_xy = [b for b in enp["blacklist"]]
    ex.trailing_poses = [t for t in enp["trailing"]]
    ex._goal_xy = enp["goal"] if enp["goal"].shape == (2,) else None
    ex.state = ExplorationState(int(meta["state_enum"]))
    for k, v in meta["diag"].items():
        setattr(ex.diag, k, v)
    ex._search_radius = float(meta["search_radius"])
    ex._goal_heading = float(meta["goal_heading"])
    ex._goal_sent_tick = int(meta["goal_sent_tick"])
    if system.ekf is not None and "ekf_map" in groups:
        system.ekf.odom_state = arrays_to_pytree(system.ekf.odom_state, groups["ekf_odom"])
        system.ekf.map_state = arrays_to_pytree(system.ekf.map_state, groups["ekf_map"])
        # rows buffered before the load would corrupt the restored states
        system.ekf._odom_rows.clear()
        system.ekf._map_rows.clear()
        system._ekf_dirty = False
        system._slam_fuse_counter = 1   # the datum is already seeded
    ex._goal_failures = {tuple(int(x) for x in k.split(",")): v
                         for k, v in meta["goal_failures"].items()}
    ex._fi_exhaustive_retry = bool(meta["fi_exhaustive_retry"])
    ex._fi_retries = int(meta.get("fi_retries", 0))
    ex._fi_drop_count = int(meta.get("fi_drop_count", 0))
    ex._recovery_ticks_left = int(meta["recovery_ticks_left"])
