"""State carried across between the reference and the port.

``to_torch`` turns a reference NamedTuple (``SE3``, ``Intrinsics``,
``FrameFeatures``, ``StereoFrame``, ``TrackState``, ``SlamMap``,
``Observations``, ``BAProblem``, ``Matches``, ``Frontiers``,
``FrontierCosts``, ``PathPlan``, ``Roadmap``), given with numpy leaves, into
the port's NamedTuple of tensors on a device; ``to_numpy`` turns a port
NamedTuple back into the same structure with numpy leaves. ``GridSpec2D`` is
static geometry of Python numbers on both sides and passes through as the
port's ``GridSpec2D`` with its numbers unchanged. Field names,
shapes and dtypes are the same on both sides (bfloat16 travels as float32
through numpy, which has no bfloat16 of its own). The parity tests move
every input and output through these two functions.

This module imports no jax: a caller converts jax arrays with ``np.asarray``
first (for example ``jax.tree.map(np.asarray, tree)``).
"""

from __future__ import annotations

from typing import Dict, Type

import numpy as np
import torch

from fitslam_tpu_torch.models.costs import FrontierCosts, PathPlan
from fitslam_tpu_torch.models.roadmap import Roadmap
from fitslam_tpu_torch.models.slam_map import SlamMap
from fitslam_tpu_torch.models.tracking import StereoFrame, TrackState
from fitslam_tpu_torch.ops.ba import BAProblem, Observations
from fitslam_tpu_torch.ops.frontier import Frontiers
from fitslam_tpu_torch.ops.geometry import Intrinsics
from fitslam_tpu_torch.ops.grid import GridSpec2D
from fitslam_tpu_torch.ops.lie import SE3
from fitslam_tpu_torch.ops.matching import Matches
from fitslam_tpu_torch.ops.orb import FrameFeatures

PORT_TYPES: Dict[str, Type] = {
    cls.__name__: cls
    for cls in (SE3, Intrinsics, FrameFeatures, StereoFrame, TrackState, SlamMap,
                Observations, BAProblem, Matches, Frontiers, FrontierCosts, PathPlan,
                Roadmap)
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
    return _leaf_to_torch(tree, device)


def to_numpy(tree):
    """Port NamedTuple of tensors -> the same NamedTuple with numpy leaves
    (bfloat16 as float32)."""
    if isinstance(tree, GridSpec2D):
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(tree)
