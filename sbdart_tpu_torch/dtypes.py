"""Dtype and device policy.

Mirrors sbdart_tpu/dtypes.py for PyTorch:

  - CPU runs (tests, golden comparisons): float64,
  - CUDA runs: float32, the precision the hand-written kernels take,
  - overridable via `SBDART_TPU_DTYPE=float32|float64` or per call.

The device is the CUDA card unless the caller asks for the CPU, per call
(`device="cpu"`) or with `SBDART_TPU_DEVICE=cpu` (`default_device`).

The solver's small-matrix algebra cancels to ~1e-5 of the operand scale,
so reduced-precision matmul passes (TF32 keeps ~3 decimal digits) break
its accuracy budget, as bf16 passes did on the TPU
(sbdart_tpu/__init__.py:42-48).  TF32 is therefore switched off for every
matmul and einsum when this module is imported.
"""

from __future__ import annotations

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def parse_dtype(name) -> torch.dtype:
    """'float32' / 'float64' (or a torch dtype) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    key = str(name).removeprefix("torch.")
    if key not in _DTYPES:
        raise ValueError(f"dtype {name!r}: use float32 or float64")
    return _DTYPES[key]


def default_device() -> torch.device:
    """The device a call runs on when it names none: the CUDA card, or the
    CPU where the caller asks for it with `SBDART_TPU_DEVICE=cpu` (the
    counterpart of the JAX package's `JAX_PLATFORMS=cpu`).  Without a card
    and without that request it raises: the port never falls back to the
    CPU on its own."""
    env = os.environ.get("SBDART_TPU_DEVICE")
    if env:
        return torch.device(env)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "sbdart_tpu_torch: no CUDA device.  To run on the CPU, pass "
            "device='cpu' or set SBDART_TPU_DEVICE=cpu"
        )
    return torch.device("cuda")


def on_cuda(device=None) -> bool:
    """True when `device` (default: the default device) is a CUDA device."""
    dev = default_device() if device is None else torch.device(device)
    return dev.type == "cuda"


def default_dtype(device=None) -> torch.dtype:
    env = os.environ.get("SBDART_TPU_DTYPE")
    if env:
        return parse_dtype(env)
    return torch.float32 if on_cuda(device) else torch.float64
