"""Host data as tensors, for the frozen solver copy beside this file.

The program's own module of this name also captures CUDA graphs and
caches tables for the life of its process; the reference needs neither,
so these three helpers only convert.  Later PRs do not edit this file.
"""

from __future__ import annotations

import numpy as np
import torch


def const(x, dtype=None, device=None) -> torch.Tensor:
    """Host data as a tensor of `dtype` (None: the data's own) on `device`."""
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def index(idx, device) -> torch.Tensor:
    """An integer index array as an int64 tensor on `device`."""
    return torch.as_tensor(np.asarray(idx, np.int64), device=device)


def as_device(x, dtype, device) -> torch.Tensor:
    """A solve argument as a tensor of `dtype` on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)
