"""Hand-written CUDA kernels for Hopper (sm_90a), one module per kernel.

Each module holds the wrapper, which launches the kernel on CUDA tensors
and counts its launches in `<wrapper>.launches`, and the plain torch
version of the same math, which the wrapper runs on CPU tensors and the
tests and chip_smoke.py compare against.  Sources live in csrc/ and are
built at first use by _build.py.
"""
