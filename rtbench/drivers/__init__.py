"""The drivers of the traffic mixes, one module a kind, found by the
name a traffic file gives under its "driver" key
(rtbench/drivers/<driver>.py).  A driver's `run_cell(cell, seed,
seconds, trace, device, t_start, mesh_band)` runs set-up, the window
and, on rank 0, the comparison with the reference, and returns the
run's outcome (harness/cell.py reads it).  A new kind of traffic adds a
module here; no existing file is edited for it."""
