"""Welsh Synthesizer Cookbook patch loading and parameter derivation.

Mirrors settings/src/patches.rs. A Welsh patch (assets/patches/welsh/*.json)
describes a dual-oscillator subtractive voice; `derive_welsh_voice_params`
reproduces `WelshPatchSettings::derive_welsh_synth_params`
(patches.rs:87-171) including its quirks:

  - oscillators with waveform "none" are dropped (patches.rs:88-95);
  - when oscillator-2-track is false, osc2 runs at a fixed frequency from
    its `note` tune (patches.rs:92-100);
  - noise > 0 adds a third, noise oscillator (patches.rs:103-108);
  - oscillator mix: 0 oscillators -> 0; one oscillator or both mixes 0 ->
    1.0; else osc1_mix/(osc1_mix+osc2_mix) (patches.rs:123-132);
  - amp and filter envelope *release is replaced by decay*
    (patches.rs:133-138, 150-159) — reproduced deliberately for fidelity;
  - filter: 24db preset cutoff Hz + Q from denormalize_q(filter-resonance)
    (patches.rs:146-149); cutoff automation runs from
    frequency_to_percent(12db preset cutoff) to filter-envelope-weight
    (patches.rs:150-153).

Envelope values in patch JSON are seconds (0..30); the reference converts
through Normal via Envelope::from_seconds_to_normal and back — a lossless
round trip for the engine, so we keep seconds directly (SURVEY.md §7).

Data-quirk policy (loader must accept the whole 106-patch corpus): unknown
LFO routings map to the closest supported routing with a warning; raw float
depths are treated as pct; raw float tunes as ratio floats; polyphony
"all"/"" map to multi. The reference *panics* on bad patch JSON
(patches.rs:76-84); we raise a clean error instead.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Optional

from groove_tpu_torch.core import types as T
from groove_tpu_torch.project.paths import Paths
from groove_tpu_torch.project.schema import warn


# --------------------------------------------------------------------------
# Waveforms (groove-core::generators::Waveform, mirrored at patches.rs:173-189)

WAVEFORMS = (
    "none", "sine", "square", "pulse-width", "triangle", "sawtooth",
    "noise", "debug-zero", "debug-max", "debug-min", "triangle-sine",
)


@dataclass(frozen=True)
class Waveform:
    kind: str                 # one of WAVEFORMS
    pulse_width: float = 0.5  # used when kind == "pulse-width"

    @classmethod
    def from_json(cls, w) -> "Waveform":
        if isinstance(w, dict):
            kind, val = next(iter(w.items()))
            if kind == "pulse-width":
                return cls("pulse-width", float(val))
            raise ValueError(f"unknown waveform {w!r}")
        w = str(w)
        if w not in WAVEFORMS:
            raise ValueError(f"unknown waveform {w!r}")
        return cls(w)


def tune_ratio_from_json(t) -> float:
    """OscillatorTune -> frequency ratio (patches.rs:200-214).

    note(_) -> 1.0 (the note is used for fixed frequency instead);
    float(v) -> v; osc{octave,semi,cent} -> 2^((12o+s)*100+c)/1200).
    Raw floats appear in 2 patches (data quirk) and act like float(v).
    """
    if isinstance(t, dict):
        kind, val = next(iter(t.items()))
        if kind == "note":
            return 1.0
        if kind == "float":
            return float(val)
        if kind == "osc":
            semis = int(val.get("octave", 0)) * 12 + int(val.get("semi", 0))
            return T.semis_and_cents(semis, float(val.get("cent", 0)))
        raise ValueError(f"unknown tune {t!r}")
    return float(t)


def tune_note_from_json(t) -> Optional[int]:
    if isinstance(t, dict) and "note" in t:
        return int(t["note"])
    return None


# --------------------------------------------------------------------------
# LFO

LFO_ROUTINGS = (
    # Core enum (patches.rs:271-278)
    "none", "amplitude", "pitch", "pulse-width", "filter-cutoff",
    # Extended routings present in the patch corpus (grep census; SURVEY §2.2)
    "pitch-osc2", "pw-osc1", "pw-osc2", "resonance", "cutoff-amp",
)


@dataclass(frozen=True)
class LfoPreset:
    routing: str = "none"
    waveform: Waveform = field(default_factory=lambda: Waveform("sine"))
    frequency: float = 0.0
    depth: float = 0.0        # Normal [0,1] (patches.rs:286-298 LfoDepth->Normal)

    @classmethod
    def from_json(cls, d: dict) -> "LfoPreset":
        routing = str(d.get("routing", "none"))
        if routing not in LFO_ROUTINGS:
            warn(f"unknown LFO routing {routing!r}; treating as none")
            routing = "none"
        depth = d.get("depth", "none")
        if isinstance(depth, dict):
            kind, val = next(iter(depth.items()))
            if kind == "pct":
                depth_n = float(val)
            elif kind == "cents":
                # LfoDepth::Cents -> Normal(1 - ratio(cents)) (patches.rs:293-296)
                depth_n = 1.0 - T.semis_and_cents(0, float(val))
            else:
                warn(f"unknown LFO depth {depth!r}; 0")
                depth_n = 0.0
        elif depth == "none":
            depth_n = 0.0
        else:
            depth_n = float(depth)  # raw float data quirk: treat as pct
        wf = d.get("waveform", "sine")
        try:
            waveform = Waveform.from_json(wf)
        except ValueError:
            warn(f"unknown LFO waveform {wf!r}; sine")
            waveform = Waveform("sine")
        return cls(
            routing=routing,
            waveform=waveform,
            frequency=float(d.get("frequency", 0.0)),
            depth=depth_n,
        )


# --------------------------------------------------------------------------
# Envelope (seconds domain; groove-core EnvelopeParams contract)


@dataclass(frozen=True)
class EnvelopeSeconds:
    attack: float = 0.0
    decay: float = 0.0
    sustain: float = 1.0   # level 0..1
    release: float = 0.0

    @classmethod
    def from_json(cls, d: dict) -> "EnvelopeSeconds":
        return cls(
            attack=float(d.get("attack", 0.0)),
            decay=float(d.get("decay", 0.0)),
            sustain=float(d.get("sustain", 1.0)),
            release=float(d.get("release", 0.0)),
        )


# --------------------------------------------------------------------------
# Welsh patch -> voice params


@dataclass(frozen=True)
class OscSettings:
    waveform: Waveform
    tune_ratio: float
    tune_note: Optional[int]
    mix: float


@dataclass(frozen=True)
class WelshVoiceParams:
    """Derived per-voice parameters (groove-entities WelshVoiceParams,
    assembled at patches.rs:110-169)."""

    oscillator_1: OscSettings
    oscillator_2: OscSettings
    oscillator_2_sync: bool
    oscillator_2_fixed_hz: Optional[float]   # when oscillator-2-track is false
    noise: float                             # >0 adds a noise oscillator
    oscillator_mix: float                    # osc1 share of (osc1+osc2)
    amp_envelope: EnvelopeSeconds
    lfo: LfoPreset
    filter_cutoff_hz: float                  # 24db preset cutoff
    filter_q: float                          # denormalize_q(filter-resonance)
    filter_cutoff_start: float               # pct of hearing range
    filter_cutoff_end: float                 # filter-envelope-weight
    filter_envelope: EnvelopeSeconds
    polyphony: str                           # multi|mono|multi-limit
    poly_limit: int = 0
    gain: float = 1.0
    pan: float = 0.0
    # glide/unison are RECONSTRUCTED IMPROVEMENTS: the reference's derive
    # DROPS both (WelshSynthParams has no slots for them,
    # patches.rs:110-169) even though 19 shipped patches carry nonzero
    # glide and screaming-sync sets unison — keeping them honors the
    # patch author's data, like the kept noise mix-in above.
    glide: float = 0.0     # portamento time in seconds (GlideSettings f32)
    unison: bool = False   # stack 3 detuned copies (+/- UNISON_CENTS)


def patch_name_to_settings_name(name: str) -> str:
    """CamelCase -> kebab-case (patches.rs:52-56); kebab passes through."""
    s = re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "-", name)
    s = re.sub(r"(?<=[A-Za-z])(?=[0-9])", "-", s)
    return s.replace(" ", "-").lower()


@dataclass
class WelshPatchSettings:
    name: str
    raw: dict

    @classmethod
    def from_json_str(cls, text: str, name: str = "") -> "WelshPatchSettings":
        from groove_tpu_torch.project.schema import ProjectError
        try:
            d = json.loads(text)
        except ValueError as e:
            raise ProjectError(f"patch {name!r}: invalid JSON: {e}") from e
        if not isinstance(d, dict):
            raise ProjectError(f"patch {name!r}: root must be an object, "
                               f"got {type(d).__name__}")
        return cls(name=d.get("name", name), raw=d)

    @classmethod
    def by_name(cls, paths: Paths, name: str) -> "WelshPatchSettings":
        rel = paths.build_patch("welsh", f"{patch_name_to_settings_name(name)}.json")
        found = paths.search(rel)
        if found is None:
            raise FileNotFoundError(f"couldn't read patch file {rel}")
        return cls.from_json_str(found.read_text(), name)

    def derive_welsh_voice_params(self) -> WelshVoiceParams:
        """Typed-error boundary: a malformed patch (wrong-typed fields,
        missing subobjects) reports ProjectError naming the patch — the
        module-doc contract ('the reference panics on bad patch JSON; we
        raise a clean error instead'), pinned by the loader fuzz tests."""
        from groove_tpu_torch.project.schema import ProjectError
        try:
            return self._derive_welsh_voice_params()
        except ProjectError:
            raise
        except (TypeError, KeyError, IndexError, AttributeError,
                ValueError, StopIteration, OverflowError,
                ZeroDivisionError) as e:
            # Overflow/ZeroDivision: arithmetic consequences of absurd
            # numeric fields (e.g. a 1e9-octave tune) — same class
            raise ProjectError(
                f"malformed welsh patch {self.name!r}: {e}") from e

    def _derive_welsh_voice_params(self) -> WelshVoiceParams:
        d = self.raw

        def osc(key: str) -> OscSettings:
            o = d.get(key, {})
            return OscSettings(
                waveform=Waveform.from_json(o.get("waveform", "none")),
                tune_ratio=tune_ratio_from_json(o.get("tune", {"float": 1.0})),
                tune_note=tune_note_from_json(o.get("tune", {})),
                mix=float(o.get("mix-pct", 1.0)),
            )

        o1, o2 = osc("oscillator-1"), osc("oscillator-2")
        noise = float(d.get("noise", 0.0))

        # Count active oscillators the way derive_welsh_synth_params does
        # (patches.rs:88-108) to compute the mix (patches.rs:123-132).
        n_osc = (o1.waveform.kind != "none") + (o2.waveform.kind != "none") + (
            noise > 0.0
        )
        if n_osc == 0:
            mix = 0.0
        elif n_osc == 1 or (o1.mix == 0.0 and o2.mix == 0.0):
            mix = 1.0
        else:
            mix = o1.mix / (o1.mix + o2.mix)

        osc2_fixed_hz: Optional[float] = None
        if not d.get("oscillator-2-track", True) and o2.waveform.kind != "none":
            note = o2.tune_note
            if note is None:
                raise ValueError(
                    "oscillator 2 not tracking but tune is not a note "
                    "(patches.rs:92-100 panics here)"
                )
            osc2_fixed_hz = T.note_to_frequency(note)

        amp_env = EnvelopeSeconds.from_json(d.get("amp-envelope", {}))
        filt_env = EnvelopeSeconds.from_json(d.get("filter-envelope", {}))
        # Reference quirk: release := decay for both envelopes
        # (patches.rs:133-138, 154-159).
        amp_env = EnvelopeSeconds(
            amp_env.attack, amp_env.decay, amp_env.sustain, amp_env.decay
        )
        filt_env = EnvelopeSeconds(
            filt_env.attack, filt_env.decay, filt_env.sustain, filt_env.decay
        )

        poly = d.get("polyphony", "multi")
        poly_limit = 0
        if isinstance(poly, dict):
            poly_limit = int(poly.get("multi-limit", 0))
            poly = "multi-limit"
        elif poly in ("", "all"):  # data quirks
            poly = "multi"

        f24 = d.get("filter-type-24db", {})
        f12 = d.get("filter-type-12db", {})
        return WelshVoiceParams(
            oscillator_1=o1,
            oscillator_2=o2,
            oscillator_2_sync=bool(d.get("oscillator-2-sync", False)),
            oscillator_2_fixed_hz=osc2_fixed_hz,
            noise=noise,
            oscillator_mix=mix,
            amp_envelope=amp_env,
            lfo=LfoPreset.from_json(d.get("lfo", {})),
            filter_cutoff_hz=float(f24.get("cutoff-hz", 0.0)),
            filter_q=T.denormalize_q(float(d.get("filter-resonance", 0.0))),
            filter_cutoff_start=T.frequency_to_percent(
                float(f12.get("cutoff-hz", 0.0))
            ),
            filter_cutoff_end=float(d.get("filter-envelope-weight", 0.0)),
            filter_envelope=filt_env,
            polyphony=str(poly),
            poly_limit=poly_limit,
            # data quirk: octave-switch has glide: "off"; any non-numeric
            # value (incl. booleans) falls to 0 per warn-and-skip policy
            glide=float(d.get("glide", 0.0))
            if isinstance(d.get("glide", 0.0), (int, float))
            and not isinstance(d.get("glide", 0.0), bool) else 0.0,
            unison=bool(d.get("unison", False)),
        )


# --------------------------------------------------------------------------
# FM synth settings (patches.rs:691-715; demo JSON
# projects/demos/instruments/fm-synthesizer.json:20-44)


@dataclass(frozen=True)
class FmSynthParams:
    gain: float = 1.0
    pan: float = 0.0
    ratio: float = 2.0     # modulator freq = ratio * carrier
    depth: float = 1.0
    beta: float = 1.0
    carrier_envelope: EnvelopeSeconds = field(default_factory=EnvelopeSeconds)
    modulator_envelope: EnvelopeSeconds = field(default_factory=EnvelopeSeconds)

    @classmethod
    def from_json(cls, d: dict) -> "FmSynthParams":
        if "voice" in d and isinstance(d["voice"], dict):
            # beta-sweep demos nest the voice params:
            # projects/demos/instruments/fm-synthesizer-beta-*.json
            merged = dict(d["voice"])
            for k, v in d.items():
                if k != "voice":
                    merged.setdefault(k, v)
            d = merged
        return cls(
            gain=float(d.get("gain", 1.0)),
            pan=float(d.get("pan", 0.0)),
            ratio=float(d.get("ratio", 2.0)),
            depth=float(d.get("depth", 1.0)),
            beta=float(d.get("beta", 1.0)),
            carrier_envelope=EnvelopeSeconds.from_json(
                d.get("carrier-envelope", {})
            ),
            modulator_envelope=EnvelopeSeconds.from_json(
                d.get("modulator-envelope", {})
            ),
        )
