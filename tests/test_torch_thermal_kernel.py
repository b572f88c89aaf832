"""The thermal particular-solution kernel's wrapper
(sbdart_tpu_torch/kernels/thermal.py) on the CPU: what surrounds
csrc/thermal_particular.cu (tests/test_torch_thermal_cuda.py holds the
kernel to its plain version on a card; tests/test_torch_thermal.py holds
the plain version to the JAX package's).

  * CPU tensors take the plain version, bit for bit, and launch
    nothing; a tensor on any other device than a CUDA card is refused,
    not run plain;
  * the plain version, its C^pp/C^pm explicit sums over l, gives the
    old glue's output (thermal_particular on the einsums, moved to scan
    layout) to rounding;
  * the index the kernel walks (batch dims merged) reaches every
    element of each input through its own strides, stride-0 expanded
    views and non-contiguous ones alike;
  * the kernel's constants are the float32 values the plain version's
    device tables hold;
  * the wrapper is a launch counter
    (`kernels.thermal_particular_scan.launches`), and a flux solve on the
    CPU, with or without Planck, leaves it unchanged.
"""

import numpy as np
import pytest
import torch

from launch_counts import launches

from sbdart_tpu_torch import tracing
from sbdart_tpu_torch.constants import slope_tau_floor
from sbdart_tpu_torch.kernels import thermal as kt
from sbdart_tpu_torch.kernels.thermal import (
    thermal_particular_scan,
    thermal_particular_scan_plain,
)
from sbdart_tpu_torch.solver.eig import angular_tables
from sbdart_tpu_torch.solver.fluxlane import to_scan
from sbdart_tpu_torch.solver.sources import thermal_particular

COUNTER = "kernels.thermal_particular_scan.launches"


def _problem(nstr, batch=(3, 4), nlyr=5, seed=0, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    ssalb = rng.uniform(0.05, 0.999, batch + (nlyr,))
    dtau = 10.0 ** rng.uniform(-9.0, 0.3, batch + (nlyr,))
    g = rng.uniform(0.0, 0.85, batch + (nlyr,))
    gl = g[..., None] ** np.arange(nstr)
    b_level = rng.uniform(0.5, 20.0, batch + (nlyr + 1,))
    return tuple(torch.tensor(a, dtype=dtype)
                 for a in (ssalb, dtau, gl, b_level))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nstr", [4, 8, 12, 16])
def test_cpu_takes_the_plain_version_bit_for_bit(dtype, nstr):
    args = _problem(nstr, dtype=dtype)
    tab = angular_tables(nstr, 1)
    before = launches(thermal_particular_scan)
    got = thermal_particular_scan(*args, tab)
    want = thermal_particular_scan_plain(*args, tab)
    assert launches(thermal_particular_scan) == before
    assert got[3] is got[2]
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (5, nstr // 2, 12)
        assert torch.equal(g, w)


def test_a_tensor_off_the_cpu_and_off_cuda_is_refused():
    args = [a.to("meta", torch.float32) for a in _problem(4)]
    before = launches(thermal_particular_scan)
    with pytest.raises(ValueError, match="CUDA device"):
        thermal_particular_scan(*args, angular_tables(4, 1))
    assert launches(thermal_particular_scan) == before


@pytest.mark.parametrize("dtype, bar", [(torch.float64, 1e-13),
                                        (torch.float32, 2e-6)])
@pytest.mark.parametrize("nstr", [4, 16])
def test_plain_version_is_the_old_glue(dtype, bar, nstr):
    """fluxlane._thermal's former sequence: the einsums, then
    thermal_particular, then to_scan."""
    ssalb, dtau, gl, b_level = _problem(nstr, seed=2, dtype=dtype)
    tab = angular_tables(nstr, 1)
    c = 0.5 * ssalb[..., None] * torch.tensor(tab.twol1, dtype=dtype) * gl
    ylm = torch.tensor(tab.ylm[0], dtype=dtype)
    cpp = torch.einsum("...Ll,li,lj->...Lij", c, ylm, ylm)
    cpm = torch.einsum("...Ll,l,li,lj->...Lij", c,
                       torch.tensor(tab.parity[0], dtype=dtype), ylm, ylm)
    th = thermal_particular(cpp, cpm, ssalb, dtau, b_level, tab)
    got = thermal_particular_scan_plain(ssalb, dtau, gl, b_level, tab)
    for g, old in zip(got, th[:4]):
        ref = to_scan(old, 2)
        assert (g - ref).abs().max() <= bar * ref.abs().max()


def _gather(ndim, dims_host, views, nb, nlyr):
    """What the kernel reads for each (layer, batch element), through
    csrc/thermal_particular.cu's index: [ssalb, dtau, b_top, b_bot,
    gl_0 .. gl_{nstr-1}] as arrays [L, B]."""
    sizes = dims_host[:ndim]
    bstr = dims_host[ndim:5 * ndim].reshape(4, ndim)
    lstr = dims_host[5 * ndim:5 * ndim + 4]
    mstr = int(dims_host[5 * ndim + 4])
    flats = [v.as_strided((v.untyped_storage().nbytes() // v.element_size()
                           - v.storage_offset(),), (1,)) for v in views]
    nstr = views[2].shape[-1]
    out = np.empty((4 + nstr, nlyr, nb))
    for b in range(nb):
        rest, o = b, [0, 0, 0, 0]
        for d in reversed(range(ndim)):
            rest, c = divmod(rest, int(sizes[d]))
            o = [o[a] + c * int(bstr[a, d]) for a in range(4)]
        for l in range(nlyr):
            out[0, l, b] = flats[0][o[0] + l * lstr[0]]
            out[1, l, b] = flats[1][o[1] + l * lstr[1]]
            out[2, l, b] = flats[3][o[3] + l * lstr[3]]
            out[3, l, b] = flats[3][o[3] + (l + 1) * lstr[3]]
            for j in range(nstr):
                out[4 + j, l, b] = flats[2][o[2] + l * lstr[2] + j * mstr]
    return out


@pytest.mark.parametrize("case", ["c5", "stride0", "non_contiguous",
                                  "shared_b_level", "no_batch"])
def test_index_reaches_every_element_through_the_strides(case):
    ssalb, dtau, gl, b_level = _problem(4, batch=(4, 3, 2), nlyr=3, seed=3)
    ndim = {"c5": 1, "stride0": 2, "non_contiguous": 3,
            "shared_b_level": 3, "no_batch": 0}[case]
    if case == "stride0":          # one column's optics over 4 columns
        ssalb, dtau, gl = (x[:1].expand_as(x) for x in (ssalb, dtau, gl))
    elif case == "non_contiguous":
        ssalb = ssalb.transpose(0, 1).contiguous().transpose(0, 1)
        dtau = torch.cat([dtau, dtau], dim=-1)[..., ::2]
        wide = torch.zeros(gl.shape[:-1] + (7,), dtype=gl.dtype)
        wide[..., 2:6] = gl
        gl = wide[..., 2:6]
    elif case == "shared_b_level":
        b_level = b_level[:1, :, :1]
    elif case == "no_batch":
        ssalb, dtau, gl, b_level = ssalb[0, 0, 0], dtau[0, 0, 0], \
            gl[0, 0, 0], b_level[0, 0, 0]
    batch, nlyr, n = kt._shapes(ssalb, dtau, gl, b_level,
                                angular_tables(4, 1))
    views = (ssalb.expand(batch + (nlyr,)), dtau.expand(batch + (nlyr,)),
             gl.expand(batch + (nlyr, 2 * n)),
             b_level.expand(batch + (nlyr + 1,)))
    got_ndim, dims_host = kt._index(batch, views)
    assert got_ndim == ndim
    nb = int(np.prod(batch))
    got = _gather(got_ndim, dims_host, views, nb, nlyr)
    v = [to_scan(views[0]), to_scan(views[1]), to_scan(views[3][..., :-1]),
         to_scan(views[3][..., 1:])] + [to_scan(views[2][..., j])
                                        for j in range(2 * n)]
    for g, want in zip(got, v):
        np.testing.assert_array_equal(g, want.reshape(nlyr, nb).numpy())


def test_too_many_batch_dims_are_refused():
    # seven batch dims of 2 in reversed order: no neighbours merge
    ssalb = torch.rand((2,) * 7 + (3,)).permute(6, 5, 4, 3, 2, 1, 0, 7)
    batch = tuple(ssalb.shape[:-1])
    views = (ssalb, ssalb, ssalb[..., None].expand(batch + (3, 4)),
             torch.rand(batch + (4,)))
    with pytest.raises(ValueError, match="at most"):
        kt._index(batch, views)


@pytest.mark.parametrize("nstr", [4, 8, 12, 16])
def test_kernel_consts_are_the_plain_versions_float32_tables(nstr):
    tab = angular_tables(nstr, 1)
    c = kt._kernel_consts(tab)
    n = nstr // 2
    f = np.float32
    assert c.dtype == f and c.shape == (16 + 16 * 8 + 16 + 8 + 8 + 1,)
    np.testing.assert_array_equal(c[:nstr], np.asarray(tab.twol1, f))
    ylm = c[16:144].reshape(16, 8)
    np.testing.assert_array_equal(ylm[:nstr, :n], np.asarray(tab.ylm[0], f))
    assert not ylm[nstr:].any() and not ylm[:, n:].any()
    np.testing.assert_array_equal(c[144:144 + nstr],
                                  np.asarray(tab.parity[0], f))
    mu32 = torch.tensor(tab.mu, dtype=torch.float32)
    np.testing.assert_array_equal(c[160:160 + n], (1.0 / mu32).numpy())
    np.testing.assert_array_equal(c[168:168 + n], np.asarray(tab.w, f))
    assert c[-1] == f(slope_tau_floor(torch.float32))


def test_wrapper_is_a_launch_counter():
    """The wrapper counts each launch in the process counter COUNTER
    (tracing.py), which a call on CPU tensors leaves where it was."""
    import inspect

    assert f'tracing.count("{COUNTER}")' in inspect.getsource(
        thermal_particular_scan)
    before = tracing.counters()
    thermal_particular_scan(*_problem(4), angular_tables(4, 1))
    assert tracing.counters() == before


@pytest.mark.parametrize("planck", [False, True])
def test_flux_solve_on_the_cpu_leaves_the_counter(planck):
    from sbdart_tpu_torch.solver.disort import solve_rte

    rng = np.random.default_rng(4)
    kw = {}
    if planck:
        kw = dict(planck=True, temper=np.linspace(250.0, 290.0, 5),
                  wvnlo=800.0, wvnhi=900.0, btemp=290.0)
    before = launches(thermal_particular_scan)
    out = solve_rte(torch.from_numpy(rng.uniform(0.01, 0.5, (3, 4))),
                    rng.uniform(0.1, 0.9, (3, 4)),
                    np.tile(0.5 ** np.arange(5), (4, 1)), nstr=4, fbeam=1.0,
                    umu0=0.6, albedo=0.2, dtype=torch.float32, **kw)
    assert torch.isfinite(out.flup).all()
    assert launches(thermal_particular_scan) == before
