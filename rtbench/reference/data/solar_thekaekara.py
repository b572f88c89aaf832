# Frozen copy of sbdart_tpu_torch/data/solar_thekaekara.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Thekaekara (1973) standard extraterrestrial solar spectral irradiance.

TRANSCRIBED PUBLISHED TABLE (not a shape model): M. P. Thekaekara,
"Solar energy outside the earth's atmosphere", Solar Energy 14, 109-127
(1973); the NASA/ASTM standard of its era, reproduced in Iqbal, "An
Introduction to Solar Radiation" (1983), Table 3.3.1, and in the LOWTRAN
report series.  Solar constant of the compilation: 1353 W/m^2.

Native grid: 10 nm in the UV/visible (0.23-0.75 um with 5 nm refinement
around the 0.40-0.50 peak region in the original; the widely reprinted
table below is the 10 nm column), coarser in the IR.  Values are
W m^-2 um^-1 at mean Earth-Sun distance.

This table anchors the framework's nf solar databases (data/solar.py) in
place of the earlier hand-drawn anchor set; tests/test_solar_db.py pins a
sample of the transcribed values and the integrated solar constant.

Replaces (with measured data) part of spectra.f:SOLIRR (reference
component #6, SURVEY.md section 3.3 item 5).
"""

from __future__ import annotations

import numpy as np

# wavelength [um], spectral irradiance [W/m^2/um]
THEKAEKARA_1973 = np.array([
    [0.115, 0.007], [0.120, 0.10], [0.140, 0.03], [0.160, 0.23],
    [0.180, 1.25], [0.200, 10.7], [0.220, 57.5], [0.230, 66.7],
    [0.240, 63.0], [0.250, 70.9], [0.260, 130.0], [0.270, 232.0],
    [0.280, 222.0], [0.290, 482.0], [0.300, 514.0], [0.310, 689.0],
    [0.320, 830.0], [0.330, 1059.0], [0.340, 1074.0], [0.350, 1093.0],
    [0.360, 1068.0], [0.370, 1181.0], [0.380, 1120.0], [0.390, 1098.0],
    [0.400, 1429.0], [0.410, 1751.0], [0.420, 1747.0], [0.430, 1639.0],
    [0.440, 1810.0], [0.450, 2006.0], [0.460, 2066.0], [0.470, 2033.0],
    [0.480, 2074.0], [0.490, 1950.0], [0.500, 1942.0], [0.510, 1882.0],
    [0.520, 1833.0], [0.530, 1842.0], [0.540, 1783.0], [0.550, 1725.0],
    [0.560, 1695.0], [0.570, 1712.0], [0.580, 1715.0], [0.590, 1700.0],
    [0.600, 1666.0], [0.620, 1602.0], [0.640, 1544.0], [0.660, 1486.0],
    [0.680, 1427.0], [0.700, 1369.0], [0.720, 1314.0], [0.750, 1235.0],
    [0.800, 1109.0], [0.850, 978.0], [0.900, 891.0], [0.950, 820.0],
    [1.000, 746.0], [1.100, 592.0], [1.200, 484.0], [1.300, 396.0],
    [1.400, 336.0], [1.500, 287.0], [1.600, 244.0], [1.700, 202.0],
    [1.800, 159.0], [1.900, 126.0], [2.000, 103.0], [2.100, 90.0],
    [2.200, 79.0], [2.300, 68.0], [2.400, 64.0], [2.500, 54.0],
    [2.600, 48.0], [2.700, 43.0], [2.800, 39.0], [2.900, 35.0],
    [3.000, 31.0], [3.100, 26.0], [3.200, 22.6], [3.300, 19.2],
    [3.400, 16.6], [3.500, 14.6], [3.600, 13.5], [3.700, 12.3],
    [3.800, 11.1], [3.900, 10.3], [4.000, 9.5], [4.100, 8.7],
    [4.200, 7.8], [4.300, 7.1], [4.400, 6.5], [4.500, 5.9],
    [4.600, 5.3], [4.700, 4.8], [4.800, 4.5], [4.900, 4.1],
    [5.000, 3.83], [6.000, 1.75], [7.000, 0.99], [8.000, 0.60],
    [9.000, 0.38], [10.000, 0.25], [11.000, 0.17], [12.000, 0.12],
    [13.000, 0.087], [14.000, 0.055], [15.000, 0.049], [16.000, 0.038],
    [17.000, 0.031], [18.000, 0.024], [19.000, 0.02], [20.000, 0.016],
    [25.000, 0.0061], [30.000, 0.0030], [35.000, 0.0016], [40.000, 0.0009],
    [50.000, 0.0004], [60.000, 0.0002], [80.000, 0.00006], [100.0, 0.00003],
])

# The compilation's own integral (its published solar constant):
THEKAEKARA_TSI = 1353.0  # W/m^2
