"""The total Planck function (torch port of
sbdart_tpu/solver/planck.py:planck_total).  The band-integrated one,
`planck_band`, lives beside its CUDA kernel in kernels/planck.py.
"""

from __future__ import annotations

import math

import torch

from sbdart_tpu_torch.constants import STEFAN_BOLTZMANN
from sbdart_tpu_torch.dtypes import default_device
from sbdart_tpu_torch.ops.graph import as_device


def planck_total(temp) -> torch.Tensor:
    """sigma T^4 / pi, the full-spectrum Planck radiance, in float64.  A
    tensor argument sets the device; any other goes to
    `dtypes.default_device()`."""
    dev = temp.device if isinstance(temp, torch.Tensor) else default_device()
    t = as_device(temp, torch.float64, dev)
    t2 = t * t
    return (STEFAN_BOLTZMANN / math.pi) * (t2 * t2)
