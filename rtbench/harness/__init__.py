"""The benchmark's harness: the manifest, the traffic generator, the
process grid, the profiler reader and the result line; the drivers of
the traffic kinds are in rtbench/drivers/."""
