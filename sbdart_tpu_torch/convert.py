"""Carry state across from the NumPy side to torch tensors.

The solver's "parameters" are its NumPy inputs and tables, not trained
weights: an OpticalDeck from the setup modules, the AngularTables of the
quadrature, the per-call solve_rte arrays, and a BRDF surface model.
These helpers move them onto a device in a dtype.  They accept the JAX
package's NumPy objects as well as the port's (both are NamedTuples of
numpy arrays with the same fields, and BRDF dataclasses with the same
names and fields), so tests can feed the reference's own inputs into the
port's solver.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sbdart_tpu_torch.dtypes import default_device, default_dtype, parse_dtype
from sbdart_tpu_torch.optics import OpticalDeck
from sbdart_tpu_torch.solver.eig import AngularTables


def _resolve(device, dtype):
    device = default_device() if device is None else torch.device(device)
    dtype = default_dtype(device) if dtype is None else parse_dtype(dtype)
    return device, dtype


def deck_to_torch(deck, device=None, dtype=None) -> OpticalDeck:
    """An OpticalDeck with every field as a tensor on `device`."""
    device, dtype = _resolve(device, dtype)
    return OpticalDeck(*(
        torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        for x in deck
    ))


def tables_to_torch(tab, device=None, dtype=None) -> AngularTables:
    """AngularTables with every field as a tensor on `device`."""
    device, dtype = _resolve(device, dtype)
    return AngularTables(*(
        torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        for x in tab
    ))


def rte_inputs_to_torch(device=None, dtype=None, **arrays) -> dict:
    """solve_rte keyword inputs (NumPy arrays or numbers) as tensors;
    None entries pass through."""
    device, dtype = _resolve(device, dtype)
    return {
        k: None if v is None
        else torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
        for k, v in arrays.items()
    }


def brdf_to_torch(brdf, device=None, dtype=None):
    """The port's BRDF model (solver/brdf.py) with the class name and
    parameters of `brdf` (a HapkeBrdf or RpvBrdf of either package): each
    parameter a float when it is a number or a numpy scalar, else a tensor
    on `device` in `dtype`."""
    from sbdart_tpu_torch.solver import brdf as port_brdf

    name = type(brdf).__name__
    if name not in ("HapkeBrdf", "RpvBrdf") or not dataclasses.is_dataclass(
            brdf):
        raise TypeError(f"brdf_to_torch: no port of the BRDF model {name!r}")
    cls = getattr(port_brdf, name)

    def param(v):
        a = np.asarray(v)
        if a.ndim == 0:
            return float(a)
        dev, dt = _resolve(device, dtype)
        return torch.as_tensor(a, dtype=dt, device=dev)

    return cls(**{f.name: param(getattr(brdf, f.name))
                  for f in dataclasses.fields(brdf)})
