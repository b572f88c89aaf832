"""Hand-written CUDA kernels for Hopper (sm_90a), one module per kernel.

Each module holds the wrapper, which launches the kernel where
`use_kernel` says so and counts each launch in the process counter
`kernels.<wrapper>.launches` (tracing.py), and the plain torch version
of the same math, which the wrapper runs otherwise and the tests and
chip_smoke.py compare against.  Sources live in csrc/ and are built at
first use by _build.py.

This package alone picks kernel or plain: a wrapper runs its plain
version on CPU tensors and inside a `plain()` block (solve_rte opens one
for eig_method "plain" and for every dtype but float32), and launches its
kernel on anything else, refusing what the kernel cannot take.
"""

from __future__ import annotations

import contextlib
import threading

_local = threading.local()


@contextlib.contextmanager
def plain():
    """Every kernel wrapper called on this thread inside the block runs
    its plain torch version."""
    depth = getattr(_local, "plain", 0)
    _local.plain = depth + 1
    try:
        yield
    finally:
        _local.plain = depth


def use_kernel(t) -> bool:
    """Whether a wrapper given `t` launches its kernel: `t` is off the CPU
    and no plain() block is open on this thread."""
    return t.device.type != "cpu" and not getattr(_local, "plain", 0)
