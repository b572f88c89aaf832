"""Build and load the port's CUDA kernels at first use.

Route: `nvcc` compiles kernels/csrc/*.cu for sm_90a into one shared
library with a plain C interface, and `ctypes` binds it.  No PyTorch
header is compiled, so the build takes seconds, and no `ninja` is needed.
The launchers take raw device pointers, sizes and the current CUDA stream,
and return the launch's `cudaGetLastError()` code.

The library goes to `build/torch_kernels/` at the root of the checkout
(listed in .gitignore), named by a hash of the sources and flags, so an
edited source is rebuilt and a built one is reused.  The compiler's
report (`-Xptxas=-v`: registers, spills) is kept beside it in
`build.log`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("eig_n2_deltam.cu", "blocktri_rt_n2.cu")
# IEEE sqrt/div/exp (no --use_fast_math) and no contracted multiply-adds:
# the kernels round where their plain torch versions do.
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels are built from source at first use"
        )
    return found


def _library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"libsbdart_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels unless an up-to-date library exists.

    Returns (library path, seconds spent compiling; 0.0 when reused)."""
    out = _library_path()
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    (out.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.sbdart_eig_n2_deltam.argtypes = (
        [_P] * 12 + [_I, _I, _I, _P, _P]
    )
    lib.sbdart_eig_n2_deltam.restype = _I
    lib.sbdart_blocktri_rt_n2.argtypes = [_P] * 8 + [_I, _I, _P]
    lib.sbdart_blocktri_rt_n2.restype = _I
    lib.sbdart_cuda_error_string.argtypes = [_I]
    lib.sbdart_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = library().sbdart_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def require_cuda_f32(name: str, *tensors) -> None:
    """The kernels take contiguous float32 CUDA tensors on one device."""
    import torch

    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(
                f"{name}: the CUDA kernel is float32-only, got {t.dtype} "
                "(float64 runs the plain torch version)"
            )
