# Frozen copy of sbdart_tpu_torch/namelist.py for the benchmark's reference: imports
# point into rtbench.reference.
# Later changes do not edit it.
"""Fortran NAMELIST loader for SBDART `INPUT` files.

The reference's entire user interface is one namelist, `&INPUT`, read from a
file named `INPUT` (sbdart.f: READ of namelist /INPUT/; documented in
rt.doc).  This module parses that format so existing SBDART input decks work
verbatim: `&INPUT ... /` or `$INPUT ... $end` groups, `name = v1, v2`,
repeat counts (`5*0.0`), Fortran logicals (`.true.`, `.f.`, `t`),
array-element assignment (`uzen(2) = 30`), and `!` comments.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

from rtbench.reference.config import Config

_GROUP_RE = re.compile(
    r"[&$]\s*INPUT(.*?)(?:^\s*/|\$end|&end)", re.IGNORECASE | re.DOTALL | re.MULTILINE
)
_ASSIGN_RE = re.compile(
    r"([a-zA-Z_][a-zA-Z0-9_]*)\s*(\(\s*\d+\s*\))?\s*=", re.MULTILINE
)


def _parse_token(tok: str) -> Any:
    t = tok.strip()
    if not t:
        return None
    low = t.lower()
    if low in (".true.", ".t.", "t", "true"):
        return True
    if low in (".false.", ".f.", "f", "false"):
        return False
    if t[0] in "'\"":
        return t.strip("'\"")
    t = low.replace("d", "e")  # Fortran double-precision exponent
    try:
        if re.fullmatch(r"[+-]?\d+", t):
            return int(t)
        return float(t)
    except ValueError:
        return tok.strip()


def _parse_values(raw: str) -> list:
    vals: list = []
    for piece in re.split(r"[,\s]+", raw.strip()):
        if not piece:
            continue
        m = re.fullmatch(r"(\d+)\*(.+)", piece)
        if m:
            vals.extend([_parse_token(m.group(2))] * int(m.group(1)))
        else:
            v = _parse_token(piece)
            if v is not None:
                vals.append(v)
    return vals


def loads_namelist(text: str, base: Config | None = None) -> Config:
    """Parse the text of an SBDART `INPUT` file into a Config."""
    # strip comments
    text = "\n".join(line.split("!")[0] for line in text.splitlines())
    m = _GROUP_RE.search(text + "\n")
    if m is None:
        raise ValueError("no &INPUT namelist group found")
    body = m.group(1)

    cfg = base or Config()
    fields = {f.name.lower(): f for f in dataclasses.fields(Config)}
    updates: dict[str, Any] = {}

    matches = list(_ASSIGN_RE.finditer(body))
    for i, am in enumerate(matches):
        name = am.group(1).lower()
        index = am.group(2)
        raw = body[am.end(): matches[i + 1].start() if i + 1 < len(matches) else len(body)]
        if name not in fields:
            raise ValueError(f"unknown namelist variable: {name}")
        f = fields[name]
        vals = _parse_values(raw)
        if not vals:
            continue
        current = updates.get(name, getattr(cfg, f.name))
        is_array = isinstance(current, list)
        if index is not None:
            idx = int(index.strip("() ")) - 1  # Fortran 1-based
            if not is_array:
                raise ValueError(f"{name} is scalar but indexed")
            arr = list(current)
            for j, v in enumerate(vals):
                if idx + j >= len(arr):
                    arr.extend([arr[-1] if arr else 0] * (idx + j + 1 - len(arr)))
                arr[idx + j] = v
            updates[name] = arr
        elif is_array:
            arr = list(current)
            for j, v in enumerate(vals):
                if j < len(arr):
                    arr[j] = v
                else:
                    arr.append(v)
            updates[name] = arr
        else:
            v = vals[0]
            if isinstance(current, bool):
                v = bool(v)
            elif isinstance(current, int) and not isinstance(v, bool):
                v = int(v)
            elif isinstance(current, float):
                v = float(v)
            updates[name] = v

    return cfg.replace(**updates)


def load_namelist(path: str, base: Config | None = None) -> Config:
    """Load an SBDART `INPUT` namelist file into a Config."""
    with open(path) as fh:
        return loads_namelist(fh.read(), base=base)
