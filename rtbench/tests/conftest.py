"""Tests of the benchmark (rtbench/): run with
`python -m pytest rtbench/tests -p no:cacheprovider -o addopts=''`.
Tests marked `cuda` need a card and skip without one (decided in the
`card` fixture, never at import)."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def cpu_program(monkeypatch):
    """The program on the CPU (its float64 route), as the harness's CPU
    drives need."""
    monkeypatch.setenv("SBDART_TPU_DEVICE", "cpu")
    monkeypatch.delenv("SBDART_TPU_DTYPE", raising=False)
