"""sbdart_tpu_torch — the PyTorch/CUDA port of sbdart_tpu.

The same `Config`/namelist surface, spectral pipeline and DISORT-class
solver as the JAX package `sbdart_tpu`, which stays beside it as the
reference.  Layout follows the JAX package module for module:

  - NumPy setup (config, namelist, atmosphere, gas, optics, ..., data/)
    carried across unchanged apart from imports, so the package imports
    without JAX;
  - solver/   the torch solver (delta-M, Planck, the thermal source, the
              lane-resident flux path, solve_rte); ops/ its lane-layout
              linear algebra;
  - kernels/  hand-written CUDA kernels for Hopper (csrc/*.cu), each with
              a plain torch version of the same math beside it;
  - pipeline / api / cli  the spectral loop and the sbdart-compatible CLI.

The package imports torch and never jax.
"""

from __future__ import annotations

from sbdart_tpu_torch import dtypes as _dtypes  # noqa: F401  (TF32 off)
from sbdart_tpu_torch.config import Config
from sbdart_tpu_torch.namelist import load_namelist, loads_namelist
from sbdart_tpu_torch.api import run, run_spectrum

__version__ = "0.1.0"

__all__ = [
    "Config",
    "load_namelist",
    "loads_namelist",
    "run",
    "run_spectrum",
    "__version__",
]
