"""Per-layer metric `eig_roofline.batch` (kernels; moves columns_per_s; from device_trace).

The traced span's share of the roofline of the per-layer eigen front end: the least time
of its solves (harness/work.py, counted from the cell's shapes: the
larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s float32)
over the device time of the kernels whose names match PATTERNS.
"""

from rtbench.harness import work

UNIT = "%"
LAYER = "kernels"
MOVES = "columns_per_s"
SOURCE = "device_trace"
OPERATION = "eig"
PATTERNS = ["eig_n2_scatter_kernel", "eig_n2_deltam_kernel"]


def read(obs):
    return work.roofline_share(OPERATION, obs, PATTERNS)
