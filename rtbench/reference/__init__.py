"""The benchmark's plain reference: frozen copies of the port's host
set-up modules and tables (as they stood when the benchmark was
written), of its generic solver route in plain torch, and the two
drivers `pipeline.run` (one single-column run) and `batch.run` (columns
of a batch).  Nothing here imports the program, JAX or the JAX package.
Later changes do not edit these files."""
