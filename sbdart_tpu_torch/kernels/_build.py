"""Build and load the port's CUDA kernels at first use.

Route: `nvcc` compiles each kernels/csrc/*.cu for sm_90a, all sources
at once in parallel processes, links the objects into one shared library
with a plain C interface, and `ctypes` binds it.  No PyTorch header is
compiled, so the build takes seconds, and no `ninja` is needed.
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
SOURCES = ("eig_n2_deltam.cu", "eig_n2_scatter.cu", "eig_n2_planar.cu",
           "eig_beam_group.cu", "eig_chain.cu", "blocktri_rt_n2.cu",
           "blocktri_rt.cu", "blocktri_rt_group.cu",
           "blocktri_rt_streamed.cu", "blocktri_rt_streamed_odd.cu",
           "blocktri_rt_streamed_group.cu", "blocktri_rt_bwd.cu",
           "block_thomas.cu", "radsrc.cu")
HEADERS = ("eig_n2_chain.cuh", "eig_chain.cuh", "eig_group.cuh",
           "solve_step.cuh", "group_solve.cuh", "blocktri_rt_streamed.cuh",
           "ring.cuh")
# IEEE sqrt/div/exp (no --use_fast_math) and no contracted multiply-adds:
# the kernels round where their plain torch versions do.
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


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
    for name in SOURCES + HEADERS:
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
    nvcc = _nvcc()
    objs = [tmp.with_name(f"{tmp.name}.{Path(s).stem}.o") for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    steps = list(zip(cmds, [p.returncode for p in procs], logs))
    if all(rc == 0 for _, rc, _ in steps):
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        steps.append((link, proc.returncode, proc.stdout + proc.stderr))
    seconds = time.perf_counter() - t0
    (out.parent / "build.log").write_text("".join(
        " ".join(c) + "\n" + log for c, _, log in steps))
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [(c, rc, log) for c, rc, log in steps if rc != 0]
    if failed:
        c, rc, log = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(c)}\n{log}")
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
    lib.sbdart_eig_n2_scatter.argtypes = [_P] * 9 + [_I, _I, _P, _P]
    lib.sbdart_eig_n2_scatter.restype = _I
    lib.sbdart_eig_n2_planar.argtypes = [_P] * 10 + [_I, _I, _P, _P]
    lib.sbdart_eig_n2_planar.restype = _I
    lib.sbdart_radsrc.argtypes = [_P] * 10 + [_I] * 4 + [_P, _P]
    lib.sbdart_radsrc.restype = _I
    lib.sbdart_eig_beam_group.argtypes = [_P] * 10 + [_I] * 3 + [_P, _P]
    lib.sbdart_eig_beam_group.restype = _I
    for name in ("sbdart_eig_chain", "sbdart_eig_chain_group"):
        getattr(lib, name).argtypes = [_P] * 5 + [_I, _I, _I, _P, _P]
        getattr(lib, name).restype = _I
    lib.sbdart_block_thomas.argtypes = [_P] * 7 + [_I, _I, _I, _P]
    lib.sbdart_block_thomas.restype = _I
    lib.sbdart_blocktri_rt_n2.argtypes = [_P] * 8 + [_I, _I, _P]
    lib.sbdart_blocktri_rt_n2.restype = _I
    lib.sbdart_blocktri_rt.argtypes = [_P] * 8 + [_I, _I, _I, _P]
    lib.sbdart_blocktri_rt.restype = _I
    lib.sbdart_blocktri_rt_fwd.argtypes = [_P] * 7 + [_I, _I, _I, _P]
    lib.sbdart_blocktri_rt_fwd.restype = _I
    lib.sbdart_blocktri_rt_fwd_group.argtypes = [_P] * 8 + [_I, _I, _I, _P]
    lib.sbdart_blocktri_rt_fwd_group.restype = _I
    lib.sbdart_blocktri_rt_bwd_group.argtypes = [_P] * 6 + [_I, _I, _I, _P]
    lib.sbdart_blocktri_rt_bwd_group.restype = _I
    lib.sbdart_blocktri_rt_group.argtypes = [_P] * 9 + [_I, _I, _I, _P]
    lib.sbdart_blocktri_rt_group.restype = _I
    lib.sbdart_block_thomas_group.argtypes = [_P] * 8 + [_I, _I, _I, _P]
    lib.sbdart_block_thomas_group.restype = _I
    lib.sbdart_blocktri_rt_streamed_group_bytes.argtypes = [_I, _I]
    lib.sbdart_blocktri_rt_streamed_group_bytes.restype = _I
    lib.sbdart_blocktri_rt_bwd_group_bytes.argtypes = [_I]
    lib.sbdart_blocktri_rt_bwd_group_bytes.restype = _I
    lib.sbdart_blocktri_rt_group_bytes.argtypes = [_I, _I]
    lib.sbdart_blocktri_rt_group_bytes.restype = _I
    lib.sbdart_block_thomas_group_bytes.argtypes = [_I, _I]
    lib.sbdart_block_thomas_group_bytes.restype = _I
    for name in ("blocktri_rt_group", "blocktri_rt_fwd_group",
                 "block_thomas_group"):
        fn = getattr(lib, f"sbdart_{name}_scratch")
        fn.argtypes = [_I, _I]
        fn.restype = _L
    lib.sbdart_cuda_error_string.argtypes = [_I]
    lib.sbdart_cuda_error_string.restype = ctypes.c_char_p
    return lib


def require_shared_memory(name: str, column_bytes, size: int, device,
                          what: str = "N") -> None:
    """A group kernel holds at least one column's system in shared memory
    (the rest of the column moves to device scratch where it does not fit
    beside it): raise a ValueError naming the card's opt-in limit where
    `column_bytes(size)`, the system's bytes, exceeds it, and the largest
    size that fits."""
    import torch

    limit = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    need = column_bytes(size)
    if need <= limit:
        return
    top = size
    while top > 1 and column_bytes(top) > limit:
        top -= 1
    raise ValueError(
        f"{name}: one column's system at {what} = {size} takes {need} bytes "
        f"of shared memory, above the card's opt-in limit of {limit} bytes "
        f"a block; the kernel takes {what} up to {top}")


def group_scratch(lib, entry: str, size: int, ncol: int, device):
    """The device scratch of a group kernel's far instance (`entry`'s
    floats for ncol columns at N or m = size), or None where one column
    fits in shared memory and the near instance runs."""
    import torch

    floats = getattr(lib, f"{entry}_scratch")(size, ncol)
    if floats <= 0:
        return None
    return torch.empty(floats, device=device, dtype=torch.float32)


def ptr(t) -> int | None:
    """A tensor's device pointer, or NULL for None."""
    return None if t is None else t.data_ptr()


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
