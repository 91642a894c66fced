"""Synchronised stages of one offline render: a frozen copy of
groove_tpu_torch.profile_offline's _timed and staged_render."""

from __future__ import annotations

import time
from contextlib import contextmanager

# inner seconds of each timed call in progress, outermost first
_OPEN: list = []


@contextmanager
def _timed(stages: dict, owner, name: str, key):
    """While active, every call of owner.name is synchronised on both
    sides and its host seconds added to stages[key] (key a string, or a
    function of the call's arguments), less the seconds of the timed
    calls made inside it, which count in their own stages."""
    import torch

    fn = getattr(owner, name)

    def call(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _OPEN.append(0.0)
        try:
            out = fn(*a, **kw)
            torch.cuda.synchronize()
        finally:
            inner = _OPEN.pop()
        seconds = time.perf_counter() - t0
        if _OPEN:
            _OPEN[-1] += seconds
        k = key(a) if callable(key) else key
        stages[k] = stages.get(k, 0.0) + seconds - inner
        return out

    setattr(owner, name, call)
    try:
        yield
    finally:
        setattr(owner, name, fn)


def staged_render(r) -> tuple[float, dict]:
    """One render_quantized of Renderer r with its stages synchronised:
    (seconds, {stage: seconds}). Stages: the Welsh voices up to the
    cascade, the cascades, the FM voices, the timeline scatter, each
    instrument's own work, each effect kind ("effect:<kind>"), and the
    rest (the mix, the quantizer and the fetch)."""
    import torch

    from groove_tpu_torch.engine import render
    from groove_tpu_torch.models import fm, welsh

    stages = dict.fromkeys(("voices", "cascade", "fm voices", "scatter",
                            "instruments"), 0.0)
    with _timed(stages, welsh, "render_notes_parts", "voices"), \
            _timed(stages, welsh, "apply_cascade", "cascade"), \
            _timed(stages, fm, "render_notes", "fm voices"), \
            _timed(stages, render, "scatter_notes", "scatter"), \
            _timed(stages, r, "_render_instrument", "instruments"), \
            _timed(stages, r, "_apply_effect",
                   lambda a: "effect:" + a[1].kind):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render_quantized()
        staged_s = time.perf_counter() - t0
    stages["rest"] = staged_s - sum(stages.values())
    return staged_s, stages
