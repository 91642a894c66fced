"""The comparison that decides `correct`: the program's int16 render of
one sampled call against the plain reference's render of the same song,
sample by sample, in 16-bit steps (LSB)."""

from __future__ import annotations

import numpy as np

NO_MATCH = 65536.0


def compare(program: np.ndarray, reference: np.ndarray) -> dict:
    """{"frames": frames the program delivered less the reference's,
    "max_lsb": the widest gap, "rms_lsb": the root mean square gap}."""
    out = {"frames": float(len(program) - len(reference))}
    if program.shape != reference.shape:
        # no sample lines up: past any gap two int16 signals can have
        out.update(max_lsb=NO_MATCH, rms_lsb=NO_MATCH)
        return out
    d = program.astype(np.int64) - reference.astype(np.int64)
    out["max_lsb"] = float(np.abs(d).max()) if d.size else 0.0
    out["rms_lsb"] = float(np.sqrt(np.mean(d.astype(np.float64) ** 2))) \
        if d.size else 0.0
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}});
    "frames" has the limit 0 (exact)."""
    shown, ok = {}, True
    for name, value in numbers.items():
        limit = 0.0 if name == "frames" else float(limits[name])
        within = abs(value) <= limit if name == "frames" else value <= limit
        ok = ok and within
        shown[name] = {"value": value, "limit": limit}
    return ok, shown
