"""sbdart-compatible command-line entry point (torch port).

Like the reference binary: reads the namelist file `INPUT` from the working
directory (or a path given as argv[1]), runs, prints the `iout` output to
stdout.  Optional data files (atms.dat, albedo.dat, aerosol.dat, filter.dat,
solar.dat, usrcld.dat) are picked up from the working directory exactly as
the reference does.  Runs on the CUDA device when one is present.

Usage:
    python -m sbdart_tpu_torch.cli [INPUT_PATH]
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "INPUT"

    from sbdart_tpu_torch.namelist import load_namelist
    from sbdart_tpu_torch.outputs import format_albtrn, format_iout
    from sbdart_tpu_torch.pipeline import run_albtrn, run_pipeline

    cfg = load_namelist(path).validate()
    if cfg.ibcnd == 1:
        sys.stdout.write(format_albtrn(run_albtrn(cfg)))
        return 0
    res = run_pipeline(cfg)
    sys.stdout.write(format_iout(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
