"""The Planck kernel's wrapper (sbdart_tpu_torch/kernels/planck.py) on the
CPU: what surrounds csrc/planck_band.cu (tests/test_torch_planck_cuda.py
holds the kernel to its plain version on a card).

  * CPU tensors take the plain version, bit for bit, and launch
    nothing; a tensor on any other device than a CUDA card is refused,
    not run plain;
  * the index layout the kernel walks (size-1 dims dropped, neighbours
    merged) reaches every element of the broadcast through each input's
    own strides, stride-0 expanded views and non-contiguous ones alike;
  * the kernel's constants are the float32 values ATen's CUDA kernels use
    for the plain version's Python numbers;
  * the wrapper is a launch counter (`kernels.planck_band.launches`), and
    a flux solve on the CPU, with or without Planck, leaves it unchanged.
"""

import math

import numpy as np
import pytest
import torch

from launch_counts import launches

from sbdart_tpu_torch import tracing
from sbdart_tpu_torch.constants import C2_RADIATION, STEFAN_BOLTZMANN
from sbdart_tpu_torch.kernels import planck as kp
from sbdart_tpu_torch.kernels.planck import planck_band, planck_band_plain


def _bands(shape, seed=0):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(10.0, 3000.0, shape)
    hi = lo + rng.uniform(1.0, 500.0, shape)
    t = rng.uniform(150.0, 330.0, shape)
    t.flat[::7] = 1e-4
    return lo, hi, t


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["level", "emission", "numbers"])
def test_cpu_takes_the_plain_version_bit_for_bit(dtype, case):
    lo, hi, t = (torch.from_numpy(a) for a in _bands((6, 4, 3)))
    if case == "level":
        args = (lo[..., None], hi[..., None],
                t[:1, :1, :1, None].expand(6, 4, 3, 9) + torch.arange(9.0))
    elif case == "emission":
        args = (lo, hi, t)
    else:
        args = (800.0, 900.0, t)
    before = launches(planck_band)
    got = planck_band(*args, dtype)
    want = planck_band_plain(*args, dtype)
    assert launches(planck_band) == before
    assert got.dtype == dtype and got.device.type == "cpu"
    assert torch.equal(got, want)


def test_a_tensor_off_the_cpu_and_off_cuda_is_refused():
    t = torch.full((4,), 250.0, device="meta")
    before = launches(planck_band)
    with pytest.raises(ValueError, match="CUDA device"):
        planck_band(800.0, 900.0, t, torch.float32)
    assert launches(planck_band) == before


def _gather(shape, views):
    """What the kernel reads for each output element, through _layout."""
    dims = kp._layout(shape, views)
    assert len(dims) <= kp.MAX_DIM
    n = math.prod(shape)
    out = []
    for a, v in enumerate(views):
        flat = v.as_strided((v.untyped_storage().nbytes()
                             // v.element_size() - v.storage_offset(),),
                            (1,))
        vals = np.empty(n)
        for i in range(n):
            rest, off = i, 0
            for size, strides in reversed(dims):
                rest, c = divmod(rest, size)
                off += c * strides[a]
            vals[i] = flat[off].item()
        out.append(vals.reshape(shape))
    return out, dims


@pytest.mark.parametrize("case", ["c5_level", "c5_emission", "transposed",
                                  "stepped", "scalars", "ones"])
def test_layout_reaches_every_element_through_the_strides(case):
    if case == "c5_level":           # batch.py's views as solve_rte has them
        lo = torch.rand(1, 5, 1).expand(4, 5, 3)[..., None]
        hi = lo + 20.0
        t = torch.rand(1, 5, 1, 7).expand(4, 5, 3, 7)
        ndim = 4                     # C, B, k and L+1: none merge
    elif case == "c5_emission":
        lo = torch.rand(1, 5, 1).expand(4, 5, 3)
        hi = lo + 20.0
        t = torch.rand(4, 5, 3)
        ndim = 3
    elif case == "transposed":
        lo = torch.rand(6, 5).t()
        hi = torch.rand(5, 12)[:, ::2]
        t = torch.rand(3, 5, 9)[1, :, 2:8]
        ndim = 2
    elif case == "stepped":
        lo = torch.rand(8, 1, 6)[::2]
        hi = torch.rand(6)
        t = torch.rand(4, 3, 6)
        ndim = 3
    elif case == "scalars":
        lo, hi, t = torch.tensor(1.0), torch.tensor(2.0), torch.tensor(3.0)
        ndim = 0
    else:                            # contiguous alike: one dim
        lo, hi, t = torch.rand(2, 3, 4), torch.rand(2, 3, 4), torch.rand(2, 3, 4)
        ndim = 1
    shape = torch.broadcast_shapes(lo.shape, hi.shape, t.shape)
    views = [v.expand(shape) for v in (lo, hi, t)]
    got, dims = _gather(shape, views)
    assert len(dims) == ndim
    for g, v in zip(got, views):
        np.testing.assert_array_equal(g, v.numpy())


def test_kernel_consts_are_atens_float32_scalars():
    c = kp._kernel_consts()
    assert c.dtype == np.float32 and c.shape == (7 + 9 + 5 * 16,)
    f = np.float32
    np.testing.assert_array_equal(
        c[:7], [f(C2_RADIATION), f(STEFAN_BOLTZMANN / math.pi), f(kp._PI4_15),
                f(1e-6), f(1.0), f(3.0), f(6.0)])
    np.testing.assert_array_equal(c[7:16], np.asarray(kp._POW_COEF, f))
    n = np.arange(1, 17)
    rows = c[16:].reshape(5, 16)
    np.testing.assert_array_equal(rows[0], -n.astype(f))
    for k in (1, 2, 3):              # x / n**k as ATen runs it on a card
        np.testing.assert_array_equal(rows[k], [f(1.0) / f(m**k) for m in n])
    np.testing.assert_array_equal(rows[4], [f(6.0 / m**4) for m in n])


def test_wrapper_is_a_launch_counter():
    """The wrapper counts each launch in the process counter
    `kernels.planck_band.launches` (tracing.py), which a call on CPU
    tensors leaves where it was."""
    import inspect

    assert ('tracing.count("kernels.planck_band.launches")'
            in inspect.getsource(planck_band))
    before = tracing.counters()
    planck_band(800.0, 900.0, torch.full((3,), 250.0), torch.float32)
    assert tracing.counters() == before


@pytest.mark.parametrize("planck", [False, True])
def test_flux_solve_on_the_cpu_leaves_the_counter(planck):
    from sbdart_tpu_torch.solver.disort import solve_rte

    rng = np.random.default_rng(4)
    kw = {}
    if planck:
        kw = dict(planck=True, temper=np.linspace(250.0, 290.0, 5),
                  wvnlo=800.0, wvnhi=900.0, btemp=290.0)
    before = launches(planck_band)
    out = solve_rte(torch.from_numpy(rng.uniform(0.01, 0.5, (3, 4))),
                    rng.uniform(0.1, 0.9, (3, 4)),
                    np.tile(0.5 ** np.arange(5), (4, 1)), nstr=4, fbeam=1.0,
                    umu0=0.6, albedo=0.2, dtype=torch.float32, **kw)
    assert torch.isfinite(out.flup).all()
    assert launches(planck_band) == before
