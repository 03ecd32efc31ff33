"""Reference-format parameter files: the OpenCV-YAML importer of the JAX
package's io/config.py (a copy; that module is `re` only), which
`vio.pipeline.PipelineConfig.from_params_folder` reads the reference's
`params/D455/*.yaml` with. The gflags and params-folder importers stay to
be copied with their first caller.
"""

from __future__ import annotations

import re
from typing import Any


def load_opencv_yaml(path: str) -> dict[str, Any]:
    """Parse an OpenCV-YAML parameter file (the `%YAML:1.0` dialect used
    by params/D455/*.yaml — flat key: value pairs, `#` comments, and the
    occasional inline list `[a, b, c]` or OpenCV matrix block)."""
    out: dict[str, Any] = {}
    with open(path) as f:
        txt = f.read()
    # strip the %YAML:1.0 header and document markers
    lines = [
        ln for ln in txt.splitlines()
        if not ln.strip().startswith("%YAML") and ln.strip() != "---"
    ]
    i = 0
    while i < len(lines):
        ln = lines[i].split("#", 1)[0].rstrip()
        i += 1
        m = re.match(r"^(\w[\w.]*):\s*(.*)$", ln.strip())
        if not m:
            continue
        key, val = m.group(1), m.group(2).strip()
        if val == "":
            # possibly an OpenCV matrix block (rows/cols/dt/data) — collect
            block: dict[str, Any] = {}
            while i < len(lines):
                sub = lines[i].split("#", 1)[0].strip()
                sm = re.match(r"^(\w+):\s*(.*)$", sub)
                if not sm or not lines[i].startswith((" ", "\t")):
                    break
                bkey, bval = sm.group(1), sm.group(2).strip()
                if bval.startswith("["):
                    while "]" not in bval and i + 1 < len(lines):
                        i += 1
                        bval += " " + lines[i].strip()
                block[bkey] = _parse_value(bval)
                i += 1
            out[key] = block if block else None
            continue
        if val.startswith("["):
            while "]" not in val and i < len(lines):
                val += " " + lines[i].strip()
                i += 1
        out[key] = _parse_value(val)
    return out


def _parse_value(val: str) -> Any:
    val = val.strip().strip('"')
    if val.startswith("[") and val.endswith("]"):
        inner = val[1:-1].strip()
        if not inner:
            return []
        return [_parse_value(x) for x in inner.split(",")]
    for cast in (int, float):
        try:
            return cast(val)
        except ValueError:
            pass
    return val
