"""Song compilation: SongSettings -> CompiledSong (static IR + tensors).

Port of groove_tpu/compiler/song.py. The reference module imports
models/sampler.py and models/voices.py, which import jax at the top, so
this package carries its own copy: the same code over this package's
copies of the host modules (compiler.events/automation/params, core,
project, io.midi_smf) and its own sampler/voices, Standard MIDI File
import (compile_midi_file) included.

This replaces the reference Orchestrator's dynamic entity store, MIDI bus,
and control-link dispatch (orchestration/src/orchestrator.rs:34-775) with a
one-shot compile. Ordering mirrors SongSettings::instantiate: devices ->
patch cables -> control links -> tracks -> trips (settings/src/songs.rs:
91-104), with the same warn-and-skip / hard-error policy (§3.4 of
SURVEY.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Optional

import numpy as np

from groove_tpu_torch.compiler import automation as auto_mod
from groove_tpu_torch.compiler import events as ev_mod
from groove_tpu_torch.compiler import params as param_mod
from groove_tpu_torch.core.time import (
    SAMPLE_BUFFER_SIZE,
    MusicalTime,
    SampleRate,
    render_length_frames,
)
from groove_tpu_torch.project.paths import Paths
from groove_tpu_torch.project.patches import (
    FmSynthParams,
    WelshPatchSettings,
    WelshVoiceParams,
)
from groove_tpu_torch.project.schema import ProjectError, SongSettings, warn
from groove_tpu_torch.models import sampler as sampler_mod
from groove_tpu_torch.models.voices import (apply_mono_policy,
                                            apply_multilimit_policy,
                                            glide_prev_keys)
from groove_tpu_torch.utils import profiling

MAIN_MIXER_UVID = "main-mixer"  # reserved (orchestrator.rs:104-107)


class PatchError(ValueError):
    """Invalid patch-cable types abort compilation (orchestrator.rs:263-304;
    fixture test-data/instruments-have-no-inputs.json5)."""


@dataclass
class NoteTensors:
    keys: np.ndarray        # [n] int32 (always the true performance;
    #                         unison tripling happens only in the
    #                         engines' input builders — welsh.unison_notes)
    vels: np.ndarray        # [n] float32
    on_frames: np.ndarray   # [n] int32
    off_frames: np.ndarray  # [n] int32
    # glide-source keys (models/voices.glide_prev_keys); only set for
    # welsh voices with glide > 0 — None keeps glide-free devices'
    # render graphs byte-identical to before the feature existed
    prev_keys: "np.ndarray | None" = None

    @property
    def count(self) -> int:
        return len(self.keys)


@dataclass
class DeviceIR:
    uvid: str
    role: str                  # instrument|controller|effect
    kind: str
    midi_in: int = -1
    midi_out: int = -1
    params: dict = field(default_factory=dict)      # static config (raw JSON domain)
    automation: dict = field(default_factory=dict)  # param -> domain f32 [n_blocks]
    notes: Optional[NoteTensors] = None             # instruments only
    voice: object = None                            # WelshVoiceParams / FmSynthParams
    sample_table: object = None                     # SampleTable
    drum_note_slots: Optional[dict] = None
    slots: Optional[np.ndarray] = None              # per-note sample slots


@dataclass
class CompiledSong:
    title: Optional[str]
    sample_rate: int
    bpm: float
    time_signature: tuple
    n_frames: int
    n_blocks: int
    devices: dict                      # uvid -> DeviceIR
    sinks: dict                        # sink uvid -> [source uvids] (audio)
    order: list                        # topological eval order (uvids)
    sidechain: list                    # (passthrough_uvid, target_uvid, param)
    sends: list = field(default_factory=list)  # (src, aux, amount) BusRoutes


def _audio_roles(dev: DeviceIR) -> tuple[bool, bool]:
    """(outputs_audio, accepts_audio) — patch() validation rules
    (orchestrator.rs:263-304). SignalPassthroughController is a
    controller+effect hybrid (orchestration/src/entities.rs:114-115);
    Calculator is a controller+instrument hybrid (entities.rs:88-89,
    patched to main-mixer in projects/calculator.json)."""
    is_effect = dev.role == "effect" or dev.kind == "signal-passthrough-controller"
    is_instrument = dev.role == "instrument" or dev.kind == "calculator"
    return (is_instrument or is_effect, is_effect)


def swap_test_entities(song: SongSettings) -> SongSettings:
    """The reference's `load_only_test_entities` loader mode
    (settings/src/instruments.rs:47-65, effects.rs:59-62,
    controllers.rs:119-158): every instrument becomes a
    ToyInstrument(fake_value=0.23498239), every effect a ToyEffect
    (negator), every controller a ToyController — so project-loading and
    graph-routing tests run without any real DSP. MIDI channels are
    preserved; everything else about the song (cables, patterns, tracks,
    trips) is untouched."""
    import copy

    from groove_tpu_torch.project.schema import (
        ControllerSettings,
        EffectSettings,
        InstrumentSettings,
    )

    s = copy.deepcopy(song)
    for d in s.devices:
        if d.instrument is not None:
            d.instrument = InstrumentSettings(
                kind="toy-instrument", midi_in=d.instrument.midi_in,
                params={"fake-value": 0.23498239})
        elif d.effect is not None:
            d.effect = EffectSettings(kind="toy", params={})
        elif d.controller is not None:
            # audio-hybrid controllers stay (a swapped-in ToyController
            # outputs no audio, so corpus files that patch a passthrough
            # or calculator mid-cable would hard-error — the point of
            # this mode is that every shipped project still loads)
            if d.controller.kind in ("signal-passthrough-controller",
                                     "calculator"):
                continue
            d.controller = ControllerSettings(
                kind="test", midi_in=d.controller.midi_in,
                midi_out=d.controller.midi_out, params={})
    return s


def compile_song(
    song: SongSettings,
    paths: Optional[Paths] = None,
    sample_rate: int = 44100,
    events_override: Optional[list] = None,
    end_beats_override=None,
    load_only_test_entities: bool = False,
) -> CompiledSong:
    """events_override/end_beats_override: supply precomputed NoteEvents
    (e.g. from an SMF import) instead of stamping the song's patterns.
    load_only_test_entities: swap every device for its toy test double
    before compiling (see swap_test_entities). The root span "compile"
    has a child a phase: devices (and patch cables), events, notes,
    automation (trips and controls), order (sends, evaluation order)."""
    with profiling.span("compile"):
        return _compile_song(song, paths, sample_rate, events_override,
                             end_beats_override, load_only_test_entities)


def _compile_song(song, paths, sample_rate, events_override,
                  end_beats_override, load_only_test_entities):
    if load_only_test_entities:
        song = swap_test_entities(song)
    paths = paths or Paths()
    sr = SampleRate(sample_rate)
    tempo = song.clock.tempo
    ts = song.clock.time_signature

    with profiling.span("devices"):
        # ---- devices --------------------------------------------------------
        devices: dict[str, DeviceIR] = {
            MAIN_MIXER_UVID: DeviceIR(MAIN_MIXER_UVID, "effect", "mixer")
        }
        for d in song.devices:
            if d.role == "instrument":
                ir = DeviceIR(d.uvid, "instrument", d.instrument.kind,
                              midi_in=d.instrument.midi_in,
                              params=dict(d.instrument.params))
            elif d.role == "controller":
                ir = DeviceIR(d.uvid, "controller", d.controller.kind,
                              midi_in=d.controller.midi_in,
                              midi_out=d.controller.midi_out,
                              params=dict(d.controller.params))
            else:
                ir = DeviceIR(d.uvid, "effect", d.effect.kind,
                              params=dict(d.effect.params))
            if d.uvid in devices:
                warn(f"duplicate device ID {d.uvid}; keeping the first")
                continue
            devices[d.uvid] = ir

        # ---- patch cables ---------------------------------------------------
        sinks: dict[str, list[str]] = {MAIN_MIXER_UVID: []}
        for cable in song.patch_cables:
            if len(cable) < 2:
                warn("ignoring patch cable with only one ID.")
                continue
            prev = None
            for uvid in cable:
                if prev is not None:
                    src, dst = devices.get(prev), devices.get(uvid)
                    if src is None:
                        warn(f"output patch ID '{prev}' not found.")
                    elif dst is None:
                        warn(f"input patch ID '{uvid}' not found.")
                    else:
                        outputs_audio, _ = _audio_roles(src)
                        _, accepts_audio = _audio_roles(dst)
                        if not accepts_audio:
                            raise PatchError(
                                f"Input device {uvid} doesn't transform audio and "
                                f"can't be patched from output device {prev}"
                            )
                        if not outputs_audio:
                            raise PatchError(
                                f"Output device {prev} doesn't output audio and "
                                f"can't be patched into input device {uvid}"
                            )
                        sinks.setdefault(uvid, []).append(prev)
                prev = uvid

    with profiling.span("events"):
        # ---- sequencer events + arpeggiators --------------------------------
        if events_override is not None:
            all_events, end_beats = list(events_override), end_beats_override
            if end_beats is None:
                last = max((e.off_beats for e in all_events), default=Fraction(0))
                bpm_measure = Fraction(ts.beats_per_measure)
                end_beats = -(-last // bpm_measure) * bpm_measure  # ceil measure
        else:
            all_events, end_beats = ev_mod.stamp_patterns(song)
        for dev in devices.values():
            if dev.kind == "arpeggiator":
                arp_in = [e for e in all_events if e.channel == dev.midi_in]
                arp_bpm = float(dev.params.get("bpm", tempo.bpm))
                all_events = all_events + ev_mod.arpeggiate(
                    arp_in, arp_bpm, tempo, dev.midi_out
                )
            elif dev.kind == "calculator":
                calc_clock = dev.params.get("clock", {})
                calc_bpm = float(calc_clock.get("bpm", tempo.bpm)) \
                    if isinstance(calc_clock, dict) else tempo.bpm
                calc_events = ev_mod.calculator_pattern(
                    dev.midi_out, calc_bpm, tempo
                )
                all_events = all_events + calc_events
                # the calculator self-plays: extend the performance to cover
                # its jingle (calculator.json has no patterns, so the stamped
                # end would otherwise be zero)
                last = max((e.off_beats for e in calc_events), default=Fraction(0))
                bpm_measure = Fraction(ts.beats_per_measure)
                end_beats = max(end_beats, -(-last // bpm_measure) * bpm_measure)
            elif dev.kind == "timer":
                # the performance runs until EVERY controller is finished; a
                # Timer finishes after its duration (orchestrator.rs run loop
                # :803-846; tests :1678-1737 — 4 beats @240 BPM = exactly 1 s
                # of samples, no measure rounding)
                end_beats = max(end_beats,
                                Fraction(str(dev.params.get("beats", 0))))

        n_frames = render_length_frames(tempo, sr,
                                        MusicalTime.from_beats(end_beats))
        n_blocks = n_frames // SAMPLE_BUFFER_SIZE

        frame_notes = ev_mod.quantize_events(all_events, tempo, sr)

    with profiling.span("notes"):
        # ---- per-instrument note tensors & voice params ----------------------
        for dev in devices.values():
            if dev.role != "instrument" and dev.kind != "calculator":
                continue  # calculator is a controller+instrument hybrid
            mine = [n for n in frame_notes
                    if n.channel == dev.midi_in and n.on_frame < max(n_frames, 1)]
            keys = np.asarray([n.key for n in mine], np.int32)
            vels = np.asarray([n.velocity for n in mine], np.float32)
            on = np.asarray([n.on_frame for n in mine], np.int32)
            off = np.asarray([n.off_frame for n in mine], np.int32)

            if dev.kind == "welsh":
                if "name" not in dev.params:
                    raise ProjectError(
                        f"welsh instrument {dev.uvid!r} has no 'name' (a named "
                        "patch is required; use welsh-raw for inline params)")
                patch = WelshPatchSettings.by_name(paths, dev.params["name"])
                dev.voice = patch.derive_welsh_voice_params()
            elif dev.kind == "welsh-raw":
                # inline WelshSynthParams; reuse the patch derivation on the
                # raw voice dict when present
                raw = dev.params.get("voice", dev.params)
                dev.voice = WelshPatchSettings(name="raw", raw=raw)\
                    .derive_welsh_voice_params() if "oscillator-1" in raw else None
                if dev.voice is None:
                    warn(f"{dev.uvid}: unsupported welsh-raw payload; silent")
            elif dev.kind == "fm-synthesizer":
                dev.voice = FmSynthParams.from_json(dev.params)
            elif dev.kind == "drumkit":
                table, note_slots = sampler_mod.load_drumkit(
                    paths, str(dev.params.get("name", "707"))
                )
                dev.sample_table = table
                dev.drum_note_slots = note_slots
                dev.slots = sampler_mod.assign_drum_slots(keys, note_slots)
            elif dev.kind == "sampler":
                dev.sample_table = sampler_mod.load_sample(
                    paths, str(dev.params["filename"])
                )
                dev.slots = np.zeros(len(keys), np.int32)
            elif dev.kind == "calculator":
                dev.sample_table = sampler_mod.load_calculator_kit(paths)
                nslots = dev.sample_table.data.shape[0]
                dev.slots = (keys % max(nslots, 1)).astype(np.int32)

            prev = None
            if isinstance(dev.voice, WelshVoiceParams):
                if dev.voice.polyphony == "mono":
                    off = apply_mono_policy(on, off)
                elif (dev.voice.polyphony == "multi-limit"
                      and dev.voice.poly_limit > 0):
                    off = apply_multilimit_policy(on, off, dev.voice.poly_limit)
                if dev.voice.glide > 0.0 and len(keys):
                    prev = glide_prev_keys(keys, on)
                # NOTE: unison is NOT applied here — dev.notes stays the true
                # performance (the MIDI bounce, GUI and save read it); the
                # render engines triple notes at input-build time
                # (welsh.unison_notes).

            dev.notes = NoteTensors(keys, vels, on, off, prev_keys=prev)

    with profiling.span("automation"):
        # ---- control links: trips -------------------------------------------
        initial_values: dict[tuple[str, str], float] = {}
        resolved: dict[tuple[str, str], param_mod.Param] = {}
        for trip in song.trips:
            tgt = devices.get(trip.target.id)
            if tgt is None:
                warn(f"trip {trip.id} controls nonexistent entity {trip.target.id}")
                continue
            p = param_mod.resolve(tgt.kind, trip.target.param)
            if p is None:
                warn(
                    f"trip {trip.id} not added because of error 'target "
                    f"{trip.target.id} does not have a controllable parameter "
                    f"named `{trip.target.param}`'"
                )
                continue
            key = (trip.target.id, trip.target.param)
            resolved[key] = p
            configured = param_mod.configured_value(tgt.kind, tgt.params, p)
            try:
                initial_values[key] = (
                    float(p.from_domain(float(configured)))
                    if configured is not None else 0.0
                )
            except (TypeError, ValueError) as e:
                # the reference's typed serde fields reject non-numeric
                # param values at deserialization; our kind-agnostic dict
                # loader defers that check to here
                raise ProjectError(
                    f"device {trip.target.id!r} param {trip.target.param!r} "
                    f"has a non-numeric value {configured!r}") from e

        # Trigger controllers may target a TRIP (not a device): the trip's
        # `triggered` steps latch the fired value (automation.py docstrings;
        # the reference's schema comment "then ControlTrips themselves
        # [become] controllable", settings/src/controllers.rs:34-38).
        trip_ids = {t.id for t in song.trips}
        trip_triggers: dict[str, list[tuple[float, float]]] = {}
        for ctl in song.controls:
            src = devices.get(ctl.source)
            if (src is not None and src.kind == "trigger"
                    and ctl.target.id in trip_ids):
                trip_triggers.setdefault(ctl.target.id, []).append(
                    (float(src.params.get("time", 0.0)),
                     float(src.params.get("value", 1.0)))
                )

        curves = auto_mod.compile_trips(song, n_blocks, sr, initial_values,
                                        trip_triggers)
        for (uvid, pname), curve in curves.items():
            p = resolved.get((uvid, pname))
            if p is None:
                continue
            dev = devices[uvid]
            dev.automation[p.name] = np.asarray(
                [p.to_domain(float(v)) for v in curve], np.float32
            )

        # ---- control links: `controls` section (LFO + sidechain) -------------
        sidechain: list[tuple[str, str, str]] = []
        for ctl in song.controls:
            src = devices.get(ctl.source)
            if (src is not None and src.kind == "trigger"
                    and ctl.target.id in trip_ids):
                continue  # handled above (trip-targeting trigger)
            tgt = devices.get(ctl.target.id)
            if src is None or tgt is None:
                warn(f"couldn't find control source/target for automation "
                     f"ID {ctl.id}; skipping")
                continue
            p = param_mod.resolve(tgt.kind, ctl.target.param)
            if p is None:
                warn(f"skipping automation ID {ctl.id}: target {ctl.target.id} "
                     f"has no controllable parameter '{ctl.target.param}'")
                continue
            if src.kind == "lfo":
                wf = src.params.get("waveform", "sine")
                pw = 0.5
                if isinstance(wf, dict):
                    pw = float(wf.get("pulse-width", 0.5))
                    wf = "pulse-width"
                curve = auto_mod.lfo_curve(
                    str(wf), float(src.params.get("frequency", 1.0)), pw,
                    n_blocks, tempo, sr,
                )
                tgt.automation[p.name] = np.asarray(
                    [p.to_domain(float(v)) for v in curve], np.float32
                )
            elif src.kind == "trigger":
                # Trigger fires a control value at a musical time
                # (entities.rs:135-136; params are a documented RECONSTRUCTION:
                # {time: beats, value: ControlValue}). Before the trigger time
                # the target keeps its configured value; from the containing
                # block on, the fired value holds.
                t_beats = float(src.params.get("time", 0.0))
                val = float(src.params.get("value", 1.0))
                beats = auto_mod.block_start_beats(n_blocks, tempo, sr)
                configured = param_mod.configured_value(tgt.kind, tgt.params, p)
                init = (float(p.from_domain(float(configured)))
                        if configured is not None else 0.0)
                # fire in the CONTAINING 64-frame block (block END > time),
                # matching note buffer-quantization — `starts >= time` fired
                # one block LATE whenever the time fell inside a block
                ends = np.append(beats[1:], np.inf)
                curve = np.where(ends > t_beats, val, init)
                tgt.automation[p.name] = np.asarray(
                    [p.to_domain(float(v)) for v in curve], np.float32
                )
            elif src.kind == "signal-passthrough-controller":
                sidechain.append((ctl.source, ctl.target.id, p.name))
            else:
                warn(f"skipping automation ID {ctl.id}: source kind {src.kind} "
                     f"does not emit control values")

    with profiling.span("order"):
        # ---- aux sends (BusStation routes) -----------------------------------
        sends: list[tuple[str, str, float]] = []
        for s in song.sends:
            if s.source not in devices or s.aux not in devices:
                warn(f"send {s.source} -> {s.aux}: unknown device; skipping")
                continue
            outputs_audio, _ = _audio_roles(devices[s.source])
            _, accepts_audio = _audio_roles(devices[s.aux])
            if not (outputs_audio and accepts_audio):
                warn(f"send {s.source} -> {s.aux}: incompatible roles; skipping")
                continue
            sends.append((s.source, s.aux, s.amount))

        # ---- evaluation order -------------------------------------------------
        order = _topo_order(devices, sinks, sidechain, sends)

        # Prune entities unreachable from the main mixer: the reference's
        # gather_audio DFS starts at main-mixer and never visits dangling
        # devices (orchestrator.rs:351-470) — kitchen-sink.json alone has 17
        # configured-but-unpatched effects that must not run.
        live: set = set()
        stack = [MAIN_MIXER_UVID]
        while stack:
            u = stack.pop()
            if u in live:
                continue
            live.add(u)
            stack.extend(sinks.get(u, []))
            stack.extend(s for s, aux, _ in sends if aux == u)
        # sidechain passthroughs drive params of live targets; keep them and
        # their upstream audio
        for src, tgt, _ in sidechain:
            if tgt in live and src not in live:
                stack = [src]
                while stack:
                    u = stack.pop()
                    if u in live:
                        continue
                    live.add(u)
                    stack.extend(sinks.get(u, []))
        order = [u for u in order if u in live or devices[u].role == "controller"]

    return CompiledSong(
        title=song.title,
        sample_rate=sample_rate,
        bpm=tempo.bpm,
        time_signature=(ts.top, ts.bottom),
        n_frames=n_frames,
        n_blocks=n_blocks,
        devices=devices,
        sinks=sinks,
        order=order,
        sidechain=sidechain,
        sends=sends,
    )


def compile_midi_file(
    path,
    paths: Optional[Paths] = None,
    sample_rate: int = 44100,
) -> CompiledSong:
    """Compile a Standard MIDI File into a renderable song.

    The reference CLI accepts MIDI inputs (groove-cli.rs:27); instruments
    follow GM conventions: channel 10 (0-based 9) -> 707 drumkit, other
    channels -> Welsh patches via the GM program table
    (settings/src/patches.rs:336-689 equivalent, io/midi_smf.py)."""
    from groove_tpu_torch.io import midi_smf

    smf = midi_smf.parse_smf(path)
    events = midi_smf.smf_to_note_events(smf)
    channels = sorted({e.channel for e in events})
    devices = []
    cables = []
    for ch in channels:
        uvid = f"midi-ch-{ch}"
        if ch == 9:
            devices.append({"instrument": [
                uvid, {"drumkit": [{"midi-in": ch}, {"name": "707"}]}
            ]})
        else:
            patch = midi_smf.gm_program_to_patch(smf.programs.get(ch, 0))
            devices.append({"instrument": [
                uvid, {"welsh": [{"midi-in": ch}, {"name": patch}]}
            ]})
        cables.append([uvid, "main-mixer"])
    song = SongSettings.from_json({
        "title": str(path),
        "clock": {
            "bpm": smf.bpm,
            "time-signature": list(smf.time_signature),
        },
        "devices": devices,
        "patch-cables": cables,
    })
    return compile_song(song, paths, sample_rate, events_override=events)


def _topo_order(devices, sinks, sidechain, sends=()) -> list:
    """Topological order over audio edges (source -> sink) plus sidechain
    control edges (passthrough -> target) and aux-send edges."""
    deps: dict[str, set] = {u: set() for u in devices}
    for sink, sources in sinks.items():
        for s in sources:
            deps.setdefault(sink, set()).add(s)
    for src, tgt, _ in sidechain:
        deps.setdefault(tgt, set()).add(src)
    for src, aux, _ in sends:
        deps.setdefault(aux, set()).add(src)
    order: list[str] = []
    ready = sorted([u for u, d in deps.items() if not d])
    deps = {u: set(d) for u, d in deps.items()}
    while ready:
        u = ready.pop(0)
        order.append(u)
        for v, d in deps.items():
            if u in d:
                d.discard(u)
                if not d and v not in order and v not in ready:
                    ready.append(v)
        ready.sort()
    if len(order) != len(deps):
        cyc = set(deps) - set(order)
        raise PatchError(f"audio/control graph has a cycle involving {sorted(cyc)}")
    return order
