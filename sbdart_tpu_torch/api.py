"""High-level run API (single column / spectrum)."""

from __future__ import annotations

from sbdart_tpu_torch.config import Config


def run(cfg: Config, **kw):
    from sbdart_tpu_torch.pipeline import run_pipeline

    return run_pipeline(cfg.validate(), **kw)


def run_spectrum(cfg: Config, **kw):
    return run(cfg, **kw)
