# Frozen copy of sbdart_tpu_torch/data/__init__.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Static physics data tables (the reference's L0 layer).

PROVENANCE: the reference mount was empty during this build (SURVEY.md
section 0), so the compiled-in DATA blocks of atms.f / taugas.f / taucloud.f /
tauaero.f / spectra.f / salbedo.f could not be extracted.  Tables that
exist as widely published compilations are TRANSCRIBED with tests pinning
published digits:

  * solar_thekaekara.py — Thekaekara (1973) solar spectral irradiance
    (integral matches the published 1353 W/m^2 solar constant to 0.1%);
  * atmospheres.py:US76_TABLE — U.S. Standard Atmosphere 1976 z/T/p
    (validated by the standard's own geopotential hydrostatic relation);
  * atmospheres.py:MCCLATCHEY_TABLES (round 5) — the five McClatchey et
    al. (1972) model atmospheres (z/p/T/rho_H2O/rho_O3, 33 levels),
    validated per layer by hydrostatic closure (< 0.8% below 50 km) and
    by published column amounts (water < 2%, ozone < 8% — confidence
    notes in the module docstring).

Everything else is REGENERATED from the same upstream physics the
reference encodes (McClatchey-class climatologies, Malkmus band-model gas
absorption with published integrated intensities, Bohren–Huffman Mie
theory, Shettle–Fenn-class aerosol models) with provenance notes per
module and curve-of-growth / line-spacing bounds in the test suite.
Numeric values are physically consistent approximations, NOT bit-identical
to SBDART's tables; the module interfaces are designed so the reference
tables can be dropped in without code changes once the mount is populated
(SURVEY.md section 8.6 checklist).
"""
