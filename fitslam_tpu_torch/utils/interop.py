"""State carried across between the reference and the port.

``to_torch`` turns a reference NamedTuple (``SE3``, ``Intrinsics``,
``FrameFeatures``, ``StereoFrame``, ``TrackState``, ``SlamMap``,
``Observations``, ``BAProblem``, ``Matches``, ``Frontiers``,
``FrontierCosts``, ``PathPlan``, ``Roadmap``, ``CloudBuffer``,
``TraversabilityGrid``, ``World``, ``EkfState``, ``MeasurementBatch``),
given with numpy leaves, into the port's
NamedTuple of tensors on a device; ``to_numpy`` turns a port NamedTuple back
into the same structure with numpy leaves. A plain tuple or list (the cell
statistics' 5-tuple) stays one, leaf by leaf, and ``None`` stays ``None``.
``GridSpec2D`` is static geometry of Python numbers on both sides and passes
through as the port's ``GridSpec2D`` with its numbers unchanged. Field names,
shapes and dtypes are the same on both sides (bfloat16 travels as float32
through numpy, which has no bfloat16 of its own). The parity tests move
every input and output through these two functions.

The EKF's state crosses with ``ekf_state_from_reference`` /
``ekf_state_to_numpy``, and a whole dual filter (both states, the navsat
datum and the rows not yet fused) with ``dual_ekf_from_reference``.

This module imports no jax: a caller converts jax arrays with ``np.asarray``
first (for example ``jax.tree.map(np.asarray, tree)``).
"""

from __future__ import annotations

from typing import Dict, Type

import numpy as np
import torch

from fitslam_tpu_torch.data.synthetic import World
from fitslam_tpu_torch.models.costs import FrontierCosts, PathPlan
from fitslam_tpu_torch.models.localization import DualEkf, EkfState, MeasurementBatch
from fitslam_tpu_torch.models.roadmap import Roadmap
from fitslam_tpu_torch.models.slam_map import SlamMap
from fitslam_tpu_torch.models.tracking import StereoFrame, TrackState
from fitslam_tpu_torch.ops.ba import BAProblem, Observations
from fitslam_tpu_torch.ops.frontier import Frontiers
from fitslam_tpu_torch.ops.geometry import Intrinsics
from fitslam_tpu_torch.ops.grid import CloudBuffer, GridSpec2D, TraversabilityGrid
from fitslam_tpu_torch.ops.lie import SE3
from fitslam_tpu_torch.ops.matching import Matches
from fitslam_tpu_torch.ops.orb import FrameFeatures

PORT_TYPES: Dict[str, Type] = {
    cls.__name__: cls
    for cls in (SE3, Intrinsics, FrameFeatures, StereoFrame, TrackState, SlamMap,
                Observations, BAProblem, Matches, Frontiers, FrontierCosts, PathPlan,
                Roadmap, CloudBuffer, TraversabilityGrid, World, EkfState, MeasurementBatch)
}


def _leaf_to_torch(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16 from jax
        return torch.as_tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.as_tensor(np.array(a), device=device)


def to_torch(tree, device=None):
    """Reference NamedTuple (numpy leaves) -> port NamedTuple of tensors."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        name = type(tree).__name__
        if name == "GridSpec2D":
            return GridSpec2D(*tree)
        if name not in PORT_TYPES:
            raise TypeError(f"no port counterpart for {name}")
        cls = PORT_TYPES[name]
        if cls._fields != tree._fields:
            raise TypeError(f"{name}: field names differ: {tree._fields} vs {cls._fields}")
        return cls(*(to_torch(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(v, device) for v in tree)
    if tree is None:
        return None
    return _leaf_to_torch(tree, device)


def to_numpy(tree):
    """Port NamedTuple of tensors -> the same NamedTuple with numpy leaves
    (bfloat16 as float32)."""
    if isinstance(tree, GridSpec2D):
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(tree)


def ekf_state_from_reference(x, P, device=None) -> EkfState:
    """One filter state (numpy x (..., 15), P (..., 15, 15)) as the port's
    float32 ``EkfState``."""
    return EkfState(x=torch.tensor(np.asarray(x, np.float32), device=device),
                    P=torch.tensor(np.asarray(P, np.float32), device=device))


def ekf_state_to_numpy(state: EkfState) -> EkfState:
    """The port's ``EkfState`` with numpy leaves."""
    return to_numpy(state)


def dual_ekf_from_reference(ref, device=None) -> DualEkf:
    """The port's ``DualEkf`` in the state of the reference's ``ref``: its
    process noise, GPS variance, both filters' states, the navsat datum and
    the rows buffered for the next flush (numpy tuples on both sides)."""
    dual = DualEkf(Q=torch.tensor(np.asarray(ref.Q, np.float32)), gps_var=ref.gps_var,
                   device=device or "cpu")
    dual.odom_state = ekf_state_from_reference(ref.odom_state.x, ref.odom_state.P, dual.device)
    dual.map_state = ekf_state_from_reference(ref.map_state.x, ref.map_state.P, dual.device)
    dual.navsat.datum = ref.navsat.datum
    dual._odom_rows = [tuple(v.copy() for v in r) for r in ref._odom_rows]
    dual._map_rows = [tuple(v.copy() for v in r) for r in ref._map_rows]
    return dual
