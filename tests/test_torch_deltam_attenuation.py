"""The nstr=4 thermal front end's delta-M and beam-attenuation kernel
(sbdart_tpu_torch/kernels/deltam_attenuation.py) on the CPU: what
surrounds csrc/deltam_attenuation.cu
(tests/test_torch_deltam_attenuation_cuda.py holds the kernel to its
plain version on a card).

  * the plain version, its scans an explicit loop of adds, gives the old
    glue's output (apply_deltam, cumsum attenuations, to_scan) in float64
    to 1e-14 of each output's largest magnitude: delta-M on and off,
    nmom <= nstr, lanes without a beam, stride-0 broadcast mu0 and
    has_beam;
  * front_end(..., nstr=4, planck=True) gives the old route's FrontEnd
    fields, its delta-M result batch-major views of the scan-layout ones;
  * the nstr=4 Planck flux lane on a [columns, bands, k] batch with
    broadcast optics and beams, delta-M on and off, against the JAX
    package's solve at tests/test_torch_solver.py's float64 bar;
  * CPU tensors take the plain version bit for bit and launch nothing; a
    tensor on any other device than a CUDA card is refused, not run
    plain;
  * the index the kernel walks (batch dims merged) reaches every element
    of each input through its own strides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from launch_counts import launches

from sbdart_tpu.solver.disort import solve_rte as ref_solve_rte
from sbdart_tpu_torch.kernels.deltam_attenuation import (
    _batch,
    _index,
    deltam_attenuation,
    deltam_attenuation_plain,
)
from sbdart_tpu_torch.kernels.eig_n2_scatter import eig_beam_scatter_n2
from sbdart_tpu_torch.solver.deltam import apply_deltam
from sbdart_tpu_torch.solver.disort import solve_rte
from sbdart_tpu_torch.solver.eig import angular_tables
from sbdart_tpu_torch.solver.fluxlane import beam_rows, front_end, to_scan


def _problem(nmom=5, batch=(3, 2, 4), nlyr=7, seed=0, dtype=torch.float64,
             broadcast_beam=False):
    """Optics [batch, L] and [batch, L, nmom] with a conservative and a
    zero-albedo layer, a moment past 1 (f clamped) and a zero layer;
    beams on the batch, or broadcast over all but its last dim; about a
    third of the lanes without a beam, one at umu0 0."""
    rng = np.random.default_rng(seed)
    dtau = rng.uniform(0.0, 2.0, batch + (nlyr,))
    dtau[..., 2] = 0.0
    ssalb = rng.uniform(0.0, 1.0, batch + (nlyr,))
    ssalb[..., 0] = 1.0
    ssalb[..., 1] = 0.0
    g = rng.uniform(-0.2, 0.95, batch + (nlyr,))
    pmom = g[..., None] ** np.arange(nmom)
    if nmom > 4:
        pmom[..., 3, 4] = 1.5
    bshape = (1,) * (len(batch) - 1) + batch[-1:] if broadcast_beam \
        else batch
    fbeam = np.where(rng.uniform(size=bshape) < 0.66, 1.0, 0.0)
    umu0 = rng.uniform(0.2, 1.0, bshape)
    umu0.flat[0] = 0.0
    t = [torch.tensor(a, dtype=dtype) for a in (dtau, ssalb, pmom)]
    has_beam, mu0, _, _ = beam_rows(torch.tensor(fbeam, dtype=dtype),
                                    torch.tensor(umu0, dtype=dtype))
    return (*t, mu0.expand(batch), has_beam.expand(batch))


def _old_route(dtau, ssalb, pmom, mu0, has_beam, deltam):
    """fluxlane.front_end's former nstr=4 Planck sequence."""
    dm = apply_deltam(dtau, ssalb, pmom, 4, deltam)

    def attenuation(d):
        tau = torch.cumsum(d, dim=-1)
        tau = torch.cat([torch.zeros_like(tau[..., :1]), tau], dim=-1)
        return to_scan(torch.where(has_beam[..., None],
                                   torch.exp(-tau / mu0[..., None]), 0.0))

    return (to_scan(dm.dtau), to_scan(dm.ssalb), to_scan(dm.gl, 2),
            attenuation(dm.dtau), attenuation(dm.dtau_unscaled)), dm


def _close(got, ref, bar):
    assert got.shape == ref.shape
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    keep = ~torch.isnan(ref)
    scale = max(float(ref[keep].abs().max()), 1e-300)
    assert float((got - ref)[keep].abs().max()) <= bar * scale


@pytest.mark.parametrize("deltam, nmom, broadcast_beam", [
    (True, 5, False), (False, 5, False), (True, 4, False), (True, 3, True),
    (True, 9, True)])
def test_plain_version_is_the_old_glue(deltam, nmom, broadcast_beam):
    args = _problem(nmom, broadcast_beam=broadcast_beam)
    assert (~args[4]).any() and args[4].any()
    if broadcast_beam:
        assert args[3].stride()[:2] == (0, 0)
    got = deltam_attenuation_plain(*args, deltam)
    want, _ = _old_route(*args, deltam)
    names = ("dtau", "ssalb", "gl", "eb", "eb_u")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float64, name
        _close(g, w, 1e-14)
    nb = 3 * 2 * 4
    assert got[2].shape == (7, 4, nb) and got[3].shape == (8, nb)
    # no beam, no attenuation; a beam enters the top unattenuated, but
    # for a grazing one (mu0 0: -0 / 0 is NaN, as in the old glue)
    beam = args[4].reshape(-1)
    grazing = args[3].reshape(-1) == 0.0
    assert (beam & grazing).any()
    assert torch.equal(got[3][:, ~beam],
                       torch.zeros(8, int((~beam).sum()),
                                   dtype=torch.float64))
    top = got[3][0]
    assert torch.equal(top[beam & ~grazing],
                       torch.ones(int((beam & ~grazing).sum()),
                                  dtype=torch.float64))
    assert bool(top[beam & grazing].isnan().all())


@pytest.mark.parametrize("deltam", [True, False])
def test_front_end_fields_are_the_old_route(deltam):
    args = _problem(5, seed=1)
    dtau, ssalb, pmom = args[:3]
    fbeam = torch.where(args[4], 1.0, 0.0).double()
    umu0 = torch.linspace(0.2, 1.0, 24, dtype=torch.float64).reshape(3, 2, 4)
    fe = front_end(dtau, ssalb, pmom, fbeam=fbeam, umu0=umu0, deltam=deltam,
                   nstr=4, planck=True)
    has_beam, mu0, scale_row, mu0_row = beam_rows(fbeam, umu0)
    (dts, ss, gl, eb, eb_u), dm = _old_route(dtau, ssalb, pmom, mu0,
                                             has_beam, deltam)
    kk, gp, gm, zp, zm = eig_beam_scatter_n2(ss, gl, scale_row, mu0_row,
                                             angular_tables(4, 1))
    ee = torch.exp(-kk * dts[:, None, :])
    for name, want in (("kk", kk), ("gp", gp), ("gm", gm), ("zp", zp),
                       ("zm", zm), ("ee", ee), ("eb", eb), ("eb_u", eb_u),
                       ("dtau_scan", dts)):
        _close(getattr(fe, name), want, 1e-14)
    # the delta-M result, batch-major, as the thermal source reads it
    for name in ("dtau", "ssalb", "gl"):
        g = getattr(fe.dm, name)
        assert g.shape == getattr(dm, name).shape, name
        _close(g, getattr(dm, name), 1e-14)
    assert fe.dm.dtau_unscaled is dtau and fe.dm.f is None


@pytest.mark.parametrize("deltam", [True, False])
def test_flux_lane_with_planck_matches_reference(deltam):
    """Config 5's layout: optics [C, B, k, L], moments shared by the
    k-terms (stride 0), beams per band and zenith cosines per column."""
    rng = np.random.default_rng(7)
    ncol, nband, nk, nlyr = 3, 4, 2, 6
    dtau = rng.uniform(0.001, 0.6, (ncol, nband, nk, nlyr))
    ssalb = rng.uniform(0.05, 0.999, (ncol, nband, nk, nlyr))
    g = rng.uniform(0.0, 0.85, (ncol, nband, 1, nlyr))
    pmom = g[..., None] ** np.arange(5)
    kw = dict(fbeam=np.array([1.0, 0.0, 2.0, 0.0])[None, :, None],
              umu0=rng.uniform(0.2, 1.0, (ncol, 1, 1)),
              albedo=rng.uniform(0.0, 0.8, (1, nband, 1)), fisot=0.3,
              temper=np.linspace(250, 290, nlyr + 1), wvnlo=800.0,
              wvnhi=900.0, btemp=290.0)
    ref = ref_solve_rte(*(jnp.asarray(a) for a in (dtau, ssalb, pmom)),
                        nstr=4, **{k: jnp.asarray(v) for k, v in kw.items()},
                        planck=True, deltam=deltam, onlyfl=True,
                        dtype=jnp.float64, eig_method="xla",
                        bvp_method="scan")
    got = solve_rte(dtau, ssalb, pmom, nstr=4, **kw, planck=True,
                    deltam=deltam, dtype=torch.float64, device="cpu")
    for name in ("rfldir", "rfldn", "flup", "dfdt", "uavg"):
        r = np.asarray(getattr(ref, name))
        a = getattr(got, name).numpy()
        assert a.shape == r.shape and np.isfinite(a).all()
        assert np.abs(a - r).max() <= 1e-10 * np.abs(r).max(), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_takes_the_plain_version_bit_for_bit(dtype):
    args = _problem(5, dtype=dtype, broadcast_beam=True)
    before = launches(deltam_attenuation)
    got = deltam_attenuation(*args)
    want = deltam_attenuation_plain(*args)
    assert launches(deltam_attenuation) == before
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(g.nan_to_num(), w.nan_to_num())


def test_a_tensor_off_the_cpu_and_off_cuda_is_refused():
    args = [a.to("meta") for a in _problem(5, dtype=torch.float32)]
    before = launches(deltam_attenuation)
    with pytest.raises(ValueError, match="CUDA device"):
        deltam_attenuation(*args)
    assert launches(deltam_attenuation) == before


def _gather(ndim, dims_host, views, nb, nlyr, nmom):
    """What the kernel reads for each (layer, batch element) through
    csrc/deltam_attenuation.cu's index: [dtau, ssalb, pmom_0 ..
    pmom_{nmom-1}] as arrays [L, B], and [mu0, has_beam] as [B]."""
    sizes = dims_host[:ndim]
    bstr = dims_host[ndim:6 * ndim].reshape(5, ndim)
    lstr = dims_host[6 * ndim:6 * ndim + 3]
    mstr = int(dims_host[6 * ndim + 3])
    flats = [v.as_strided((v.untyped_storage().nbytes() // v.element_size()
                           - v.storage_offset(),), (1,)) for v in views]
    out = np.empty((2 + nmom, nlyr, nb))
    lane = np.empty((2, nb))
    for b in range(nb):
        rest, o = b, [0] * 5
        for d in reversed(range(ndim)):
            rest, c = divmod(rest, int(sizes[d]))
            o = [o[a] + c * int(bstr[a, d]) for a in range(5)]
        lane[0, b] = flats[3][o[3]]
        lane[1, b] = flats[4][o[4]]
        for l in range(nlyr):
            out[0, l, b] = flats[0][o[0] + l * lstr[0]]
            out[1, l, b] = flats[1][o[1] + l * lstr[1]]
            for q in range(nmom):
                out[2 + q, l, b] = flats[2][o[2] + l * lstr[2] + q * mstr]
    return out, lane


def test_kernel_index_reaches_every_element_through_strides():
    dtau, ssalb, pmom, mu0, has_beam = _problem(6, batch=(3, 2, 4), nlyr=5,
                                                broadcast_beam=True,
                                                dtype=torch.float32)
    cases = {
        "contiguous": (dtau, ssalb, pmom, mu0, has_beam),
        # optics shared along a dim (stride 0), transposed batch dims, a
        # step slice and an offset moment view
        "strided": (dtau[:1].expand(3, 2, 4, 5),
                    ssalb.transpose(0, 1).contiguous().transpose(0, 1),
                    torch.cat([pmom, pmom], dim=-1)[..., 1::2],
                    mu0, has_beam),
    }
    for name, args in cases.items():
        batch, nlyr = _batch(*args)
        nmom = args[2].shape[-1]
        views = (args[0].expand(batch + (nlyr,)),
                 args[1].expand(batch + (nlyr,)),
                 args[2].expand(batch + (nlyr, nmom)),
                 args[3].expand(batch), args[4].expand(batch))
        ndim, dims_host = _index(batch, views)
        assert dims_host.size == 6 * ndim + 4
        nb = int(np.prod(batch))
        got, lane = _gather(ndim, dims_host, views, nb, nlyr, nmom)
        np.testing.assert_array_equal(got[0], to_scan(views[0]).numpy(),
                                      err_msg=name)
        np.testing.assert_array_equal(got[1], to_scan(views[1]).numpy(),
                                      err_msg=name)
        for q in range(nmom):
            np.testing.assert_array_equal(got[2 + q],
                                          to_scan(views[2][..., q]).numpy(),
                                          err_msg=name)
        np.testing.assert_array_equal(lane[0], views[3].reshape(-1).numpy())
        np.testing.assert_array_equal(
            lane[1], views[4].reshape(-1).double().numpy())
