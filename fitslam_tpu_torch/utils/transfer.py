"""Host-to-device uploads that do not make the host wait.

``torch.as_tensor(array, device="cuda")`` copies from pageable memory and
waits for the device to drain its queue first: each such upload is a host
sync (ROADMAP fault F8). ``upload`` stages the value in pinned memory and copies
it on the current stream without waiting; the caching host allocator keeps
the pinned block until the copy has run.
"""

from __future__ import annotations

import numpy as np
import torch


def upload(x, device, dtype: torch.dtype = None) -> torch.Tensor:
    """A host value (number, sequence or numpy array) as a new tensor on
    ``device``; on a CUDA device the copy is queued, never waited for."""
    t = torch.tensor(np.asarray(x), dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
