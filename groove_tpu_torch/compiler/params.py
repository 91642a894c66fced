"""Controllable-parameter registry.

The reference generates this metadata with the `Control` derive macro
(proc-macros/src/control.rs:18-80): every `#[control]` field gets a
kebab-case name and an index, and incoming ControlValues (Normal 0..1) are
converted into the field's type. We replace the macro with an explicit
registry: per device kind, the controllable param names and the
ControlValue <-> domain conversions.

Conversions mirror the ensnare-core `From<ControlValue>` impls the derive
relies on:
  - FrequencyHz   <- percent_to_frequency(v) (hearing-range map)
  - Normal/f32/f64 <- v unchanged
  - BipolarNormal <- v*2 - 1
  - bitcrusher bits <- trunc(v * MAX_BITS_TO_CRUSH=15) (reconstruction)

Aliases: perf-1.json automates limiter `min`/`max` and bitcrusher
`bits-to-crush`; kitchen-sink configures `minimum`/`maximum`/`bits`.
"""

from __future__ import annotations

from typing import Callable, Optional

from groove_tpu_torch.core import types as T

Identity = lambda v: v  # noqa: E731
Bipolar = lambda v: v * 2.0 - 1.0  # noqa: E731
BipolarInv = lambda x: (x + 1.0) / 2.0  # noqa: E731
FreqFromPct = T.percent_to_frequency
PctFromFreq = T.frequency_to_percent
BitsFromV = lambda v: float(int(v * 15.0))  # noqa: E731
BitsToV = lambda b: b / 15.0  # noqa: E731


class Param:
    """(to_domain, from_domain) converter pair for one controllable param."""

    def __init__(self, name: str,
                 to_domain: Callable = Identity,
                 from_domain: Callable = Identity):
        self.name = name
        self.to_domain = to_domain
        self.from_domain = from_domain


_FILTER_COMMON = [Param("cutoff", FreqFromPct, PctFromFreq), Param("q")]

REGISTRY: dict[str, list[Param]] = {
    # effects
    "gain": [Param("ceiling")],
    "limiter": [Param("minimum"), Param("maximum")],
    "bitcrusher": [Param("bits-to-crush", BitsFromV, BitsToV)],
    "chorus": [Param("voices"), Param("delay-seconds"), Param("wet-dry-mix")],
    "compressor": [Param("threshold"), Param("ratio"),
                   Param("attack"), Param("release")],
    "delay": [Param("delay")],
    "reverb": [Param("attenuation"), Param("seconds")],
    "filter-low-pass-12db": _FILTER_COMMON,
    "filter-high-pass-12db": _FILTER_COMMON,
    "filter-all-pass-12db": _FILTER_COMMON,
    "filter-band-pass-12db": [Param("cutoff", FreqFromPct, PctFromFreq),
                              Param("bandwidth")],
    "filter-band-stop-12db": [Param("cutoff", FreqFromPct, PctFromFreq),
                              Param("bandwidth")],
    "filter-peaking-eq-12db": [Param("cutoff", FreqFromPct, PctFromFreq),
                               Param("q"), Param("db-gain")],
    "filter-low-shelf-12db": [Param("cutoff", FreqFromPct, PctFromFreq),
                              Param("db-gain")],
    "filter-high-shelf-12db": [Param("cutoff", FreqFromPct, PctFromFreq),
                               Param("db-gain")],
    "filter-low-pass-24db": [Param("cutoff", FreqFromPct, PctFromFreq),
                             Param("passband-ripple")],
    "mixer": [],
    "toy": [Param("my-value")],
    # instruments (DCA params; voice-level controls routed the same way)
    "welsh": [Param("pan", Bipolar, BipolarInv), Param("gain")],
    "welsh-raw": [Param("pan", Bipolar, BipolarInv), Param("gain")],
    "fm-synthesizer": [Param("pan", Bipolar, BipolarInv), Param("gain"),
                       Param("ratio"), Param("depth"), Param("beta")],
    "drumkit": [],
    "sampler": [],
    "oscillator": [Param("frequency", FreqFromPct, PctFromFreq)],
    "envelope": [],
    "toy-instrument": [Param("fake-value")],
}

ALIASES = {
    ("limiter", "min"): "minimum",
    ("limiter", "max"): "maximum",
    ("bitcrusher", "bits"): "bits-to-crush",
}


def resolve(kind: str, param: str) -> Optional[Param]:
    param = ALIASES.get((kind, param), param)
    for p in REGISTRY.get(kind, []):
        if p.name == param:
            return p
    return None


def to_domain_array(p: Param, v):
    """Array-safe to_domain for IN-GRAPH use: sidechain overrides are
    traced per-sample curves, and the scalar converters call
    float()/int() (BitsFromV, percent_to_frequency) which reject
    tracers. Without this, a sidechain onto a non-Identity param fed the
    raw Normal where domain units were expected (bits floor(0.9) = 0;
    a 0..1 'Hz' cutoff).

    In this package v is a float32 torch tensor on the render's device
    (the one departure of this copy from groove_tpu's, whose body is
    jax.numpy). The exponential is evaluated in float64 and rounded once
    to float32, so the CPU and a CUDA device give the same bits."""
    import torch

    if p.to_domain is Identity:
        return v
    if p.to_domain is Bipolar:
        return v * 2.0 - 1.0
    if p.to_domain is BitsFromV:
        return torch.trunc(v * 15.0)
    if p.to_domain is FreqFromPct:
        import numpy as np
        e = torch.exp((float(np.log(T.FREQUENCY_TO_LINEAR_BASE)) * v)
                      .double()).float()
        return T.FREQUENCY_TO_LINEAR_COEFFICIENT * e
    return p.to_domain(v)  # unknown converters must be elementwise-safe


def configured_value(kind: str, params: dict, p: Param):
    """The device's CONFIGURED raw-JSON value for a registry param, or
    None: checks the canonical name and any raw aliases still present in
    project data (bitcrusher stores `bits`, not `bits-to-crush` — without
    the alias check a trip/trigger's pre-automation region read 0.0
    instead of the configured bits)."""
    if p.name in params:
        return params[p.name]
    for (k, raw), canon in ALIASES.items():
        if k == kind and canon == p.name and raw in params:
            return params[raw]
    return None
