"""Whole-song rendering (port of groove_tpu/engine/render.py).

The compiled song graph is walked once per render in topological order:
instruments render into [2, n] buses, effects transform the sum of their
sources (plus aux sends), and the main mixer's bus is the song. Automation
is applied per 64-frame block exactly like the reference, upsampled to
per-sample tensors where an effect reads it per sample. The walk runs
eagerly in torch on the Renderer's device; the drumkit, the filters and
the Welsh voices' cascades run on hand kernels (ops/drums.py,
ops/iir_kernels.py, ops/biquad_kernels.py).

Welsh voices render whole-timeline: each device's notes are bucketed
by span (models/voices.bucket_notes). A bucket within the Renderer's
element cap (note_chunk_elems) renders its rows up to the cascade
(welsh.render_notes_parts), runs ONE cascade launch over all of them (K2
for 'refine' voices, K3 else) and sums the windows into the timeline
note after note (voices.scatter_notes); a bucket over the cap renders in
row chunks of it. The host control constants (oscillator
frequencies, gate seconds, coefficient tables, LFO and pitch-phase
tables) are collected here in numpy, bit for bit the reference's.

Sidechain semantics: the reference's SignalPassthroughController observes
audio during buffer b and emits its control value in buffer b + 1 — a
one-block delay, reproduced by shifting the derived per-block curve right
by one block.

FM voices render the same way without a cascade: each device's notes
are bucketed by span, each bucket renders its windows (models/fm.py; a
`ratio` curve integrates the modulator phase on the first-order scan
kernel) in row chunks of the element cap and sums them into the
timeline; the carrier frequencies and, where no `ratio` curve varies the
modulator and a bucket is within fm.HOST_PHASE_MAX_ELEMS, the mod-1
phase tables are host data. The sampler, the calculator and a drumkit at
another sample rate resample their table rows into [notes, 2, span]
windows (models/sampler.render_notes); the envelope instrument renders
[notes, span] sine windows; the oscillator and the toy instrument play
for the whole song (models/simple.py).

Every instrument and effect kind of the reference renders: drumkits
(K1 at the song's rate), Welsh and FM voices, the sampler, the
calculator, the oscillator, the envelope and toy instruments; mixer,
passthrough, gain, limiter, bitcrusher, compressor, delay, chorus,
reverb, toy, and every filter-* effect — static, automated
(host-designed coefficient curves) or sidechain-driven (coefficients
designed on the device from the sidechain's per-block values). The
compressor's follower and the reverb's combs and all-passes run on the
first-order scan kernel (ops/scan_kernels.py). An unknown instrument
kind warns and renders silence, an unknown effect kind warns and passes
through, as the reference's do.
"""

from __future__ import annotations

import numpy as np
import torch

from groove_tpu_torch.compiler import params as param_mod
from groove_tpu_torch.core.time import SAMPLE_BUFFER_SIZE
from groove_tpu_torch.project.schema import warn
from groove_tpu_torch.compiler.song import MAIN_MIXER_UVID, CompiledSong, \
    DeviceIR
from groove_tpu_torch.engine.params import inputs_from_numpy
from groove_tpu_torch.io.wav import quantize_16bit
from groove_tpu_torch.models import fm as fm_model
from groove_tpu_torch.models import sampler as sampler_model
from groove_tpu_torch.models import simple as simple_model
from groove_tpu_torch.models import welsh as welsh_model
from groove_tpu_torch.models.voices import (bucket_notes, note_freqs,
                                            scatter_notes, span_for,
                                            time_base)
from groove_tpu_torch.ops import delayfx, drums, dynamics, effects, iir
from groove_tpu_torch.ops import oscillator as osc_ops
from groove_tpu_torch.ops.dca import pan_gains
from groove_tpu_torch.utils import profiling

BLOCK = SAMPLE_BUFFER_SIZE
WELSH = ("welsh", "welsh-raw")

# Params the registry lists as controllable whose render reading is
# static: the toy effect's `my-value` has no DSP role, so a trip targeting
# it warns instead of silently pinning the static value.
STATIC_ONLY_PARAMS = {
    ("toy", "my-value"),
}

# A sidechain (signal-passthrough) value has no compile-time maximum, so
# the delay-type seconds it drives (compressor attack/release, delay,
# chorus delay-seconds) clamp to this bound. Trip curves keep their exact
# maxima.
SIDECHAIN_SECONDS_MAX = 1.0


def warn_static_only(dev) -> None:
    for pname in dev.automation:
        if (dev.kind, pname) in STATIC_ONLY_PARAMS:
            warn(f"automation of {dev.kind}.{pname} ({dev.uvid}) is not "
                 f"supported; the static value applies")
    if dev.kind == "oscillator" and "frequency" in dev.automation:
        wf = dev.params.get("waveform", "sine")
        if str(wf) == "noise":
            warn(f"automation of oscillator.frequency ({dev.uvid}) has no "
                 f"effect on the noise waveform; the trip is ignored")


def _upsample_block(curve: torch.Tensor, n: int) -> torch.Tensor:
    """Block-rate curve [n_blocks] -> per-sample [n] by hold."""
    return iir.upsample_hold(curve, n, BLOCK)


def host_effect_filter_coefs(dev, nb: int, sr: float):
    """HOST (numpy f32) coefficients of one effect-filter device over nb
    64-frame control blocks, from its static params and trip automation
    curves. Returns ("lp24", gain, secs) with gain [nb] and secs = 2
    tuples of 5 [nb] arrays, ("bq", coefs) with a 5-tuple of [nb] arrays,
    or None (not a designable filter kind). These exact bits feed both the
    fidelity planner and the render. Memoized per (DeviceIR, nb, sr)."""
    cache = getattr(dev, "_host_coef_cache", None)
    if cache is None:
        cache = {}
        dev._host_coef_cache = cache
    key = (int(nb), float(sr))
    if key not in cache:
        cache[key] = _design_effect_filter_coefs(dev, nb, sr)
    return cache[key]


def _design_effect_filter_coefs(dev, nb: int, sr: float):
    k = dev.kind

    def pb(name, default, d=dev):
        if name in d.automation:
            c = np.asarray(d.automation[name], np.float32)
            if len(c) < nb:
                c = np.pad(c, (0, nb - len(c)), mode="edge")
            return c[:nb]
        return np.full((nb,), d.params.get(name, default), np.float32)

    cutoff = pb("cutoff", 1000.0)
    if k == "filter-low-pass-24db":
        q = np.maximum(pb("passband-ripple", 0.707), np.float32(1e-3))
        gain, secs = iir.lp24_sections(cutoff, q, sr)
        gain = np.broadcast_to(np.asarray(gain, np.float32), (nb,))
        secs = [tuple(np.broadcast_to(np.asarray(c, np.float32), (nb,))
                      for c in sec) for sec in secs]
        return ("lp24", gain, secs)
    mk = {
        "filter-low-pass-12db": iir.rbj_low_pass,
        "filter-high-pass-12db": iir.rbj_high_pass,
        "filter-all-pass-12db": iir.rbj_all_pass,
    }.get(k)
    if mk is not None:
        coefs = mk(cutoff, np.maximum(pb("q", 0.707), np.float32(1e-3)), sr)
    elif k == "filter-band-pass-12db":
        coefs = iir.rbj_band_pass(
            cutoff, np.maximum(pb("bandwidth", 1.0), np.float32(1e-3)), sr)
    elif k == "filter-band-stop-12db":
        coefs = iir.rbj_band_stop(
            cutoff, np.maximum(pb("bandwidth", 1.0), np.float32(1e-3)), sr)
    elif k == "filter-peaking-eq-12db":
        coefs = iir.rbj_peaking_eq(
            cutoff, np.maximum(pb("q", 1.0), np.float32(1e-3)),
            pb("db-gain", 0.0), sr)
    elif k == "filter-low-shelf-12db":
        coefs = iir.rbj_low_shelf(cutoff, pb("db-gain", 0.0), sr)
    elif k == "filter-high-shelf-12db":
        coefs = iir.rbj_high_shelf(cutoff, pb("db-gain", 0.0), sr)
    else:
        return None
    coefs = tuple(np.broadcast_to(np.asarray(c, np.float32), (nb,))
                  for c in coefs)
    return ("bq", coefs)


def compute_filter_fidelity(compiled) -> dict:
    """Host-side fidelity routing for every filter device, with the
    reference's KERNEL semantics: uvid -> "serial" (static deep-corner
    poles) or "refine" (near-critical poles anywhere on an automated
    trajectory, or a static high-q resonance). Absent uvids keep the
    single-pass cascade. Sidechain-overridden filters have runtime
    coefficients and are not routed. Unlike the reference off-TPU there
    is no residence-based deepening of "refine" to "serial": the fused
    refined kernel is the accuracy path at the deep corner."""
    out: dict = {}
    nb = max(1, -(-compiled.n_frames // BLOCK))
    sr = float(compiled.sample_rate)
    sidechain_targets = {tgt for _, tgt, _ in compiled.sidechain}
    for dev in compiled.devices.values():
        if not dev.kind.startswith("filter-") or dev.uvid in sidechain_targets:
            continue
        designed = host_effect_filter_coefs(dev, nb, sr)
        if designed is None:
            continue
        if designed[0] == "lp24":
            a1 = np.stack([s[3] for s in designed[2]])
            a2 = np.stack([s[4] for s in designed[2]])
        else:
            a1 = np.atleast_1d(designed[1][3])
            a2 = np.atleast_1d(designed[1][4])
        static = not dev.automation
        if static and bool(np.all(a1 < iir._CRITICAL_A1)
                           & np.all(a2 > iir._CRITICAL_A2)):
            out[dev.uvid] = "serial"
        elif iir.needs_refinement(a1, a2):
            out[dev.uvid] = "refine"
    return out


# The element cap of one Welsh or FM note batch (rows x span): it bounds
# the voice pipeline's peak memory, and it decides how the timeline's sums
# group (a bucket over it renders in row chunks, each chunk's scatter
# added in turn). The CPU keeps the reference's CPU cap, so the twins
# group exactly as groove_tpu's CPU run does. A card gets a quarter of its
# memory over NOTE_PEAK_BYTES_PER_ELEM, the largest peak device bytes per
# element that one batch's own live intermediates reach above what was
# allocated before it (chip_smoke.py's bucket_peaks), measured on an
# NVIDIA H100 80GB HBM3 at 700.00 W: a Welsh voice with noise 72.0 (the
# Welsh analogue's lead, 629 x 81664, and the MIDI analogue's, 720 x
# 80768: the threefry noise's int64 words), a Welsh voice without 28.0
# (the pad, 720 x 114816), FM 32.0 (each bucket of the FM analogue, the
# largest 360 x 123648); and the voice branches the analogue leaves out
# (testing/synth.WELSH_VARIANTS): a gliding lead with noise 72.0 (629 x
# 81664), a lead under a pitch LFO on host phase tables 64.1 (280 x
# 81664), a unison pad 28.0 (2160 x 114816). That holds a whole bucket of a long song in one
# launch (some 290M elements on an 80 GB card). The reference sizes its
# accelerator cap the same way for its own memory (12 x 16M elements x ~5
# live arrays, a quarter of a 16 GB card).
NOTE_CHUNK_ELEMS_CPU = 16_000_000
NOTE_PEAK_BYTES_PER_ELEM = 73


def note_chunk_cap(device) -> int:
    """The note-batch cap for `device` (see NOTE_PEAK_BYTES_PER_ELEM)."""
    device = torch.device(device)
    if device.type != "cuda":
        return NOTE_CHUNK_ELEMS_CPU
    total = torch.cuda.get_device_properties(device).total_memory
    return int(total // 4 // NOTE_PEAK_BYTES_PER_ELEM)


def _pinned_like(y: torch.Tensor) -> torch.Tensor | None:
    """Page-locked host memory shaped as y, from torch's host caching
    allocator (a dense y's strides kept, as y.cpu() keeps them); None
    where it cannot be had."""
    try:
        return torch.empty_like(y, device="cpu", pin_memory=True)
    except RuntimeError:
        return None


class Renderer:
    """Renders one compiled song on one torch device.

    inputs: optional host (numpy) input dict to render from instead of
    this Renderer's own collection — e.g. groove_tpu's Renderer.inputs
    converted to numpy; see engine/params.inputs_from_numpy.
    note_chunk_elems: the element cap of one Welsh or FM note batch (rows
    x span); None takes note_chunk_cap(device)."""

    def __init__(self, compiled: CompiledSong, device, inputs=None,
                 note_chunk_elems: int | None = None):
        self.c = compiled
        self.device = torch.device(device)
        self.note_chunk_elems = int(note_chunk_cap(self.device)
                                    if note_chunk_elems is None
                                    else note_chunk_elems)
        self.host_inputs: dict[str, np.ndarray] = {}
        self._spans: dict[str, int] = {}
        self._buckets: dict[str, list] = {}
        self._osc_phase: dict[str, np.ndarray] = {}
        self._collect_inputs()
        self._collect_effect_filters()
        self._plan_filters()
        source = self.host_inputs if inputs is None else inputs
        # note-on frames stay on the host too: the timeline scatter loops
        # over them without waiting for the device
        self._host_on = {k: np.asarray(v) for k, v in source.items()
                         if k.endswith("/on")}
        self.inputs = inputs_from_numpy(source, self.device)
        # host constants the reference traces into its program rather
        # than ship as inputs: automated oscillators' integrated phases
        self._consts = inputs_from_numpy(self._osc_phase, self.device)

    # ---- host-side input collection --------------------------------------

    def _collect_inputs(self) -> None:
        welsh_devs = []
        for dev in self.c.devices.values():
            if (dev.role == "instrument" or dev.kind == "calculator") \
                    and dev.notes is not None:
                if dev.kind in WELSH and dev.voice is not None \
                        and dev.notes.count:
                    welsh_devs.append(dev)
                else:
                    self._collect_instrument(dev)
            warn_static_only(dev)
            for pname, curve in dev.automation.items():
                if dev.kind == "oscillator" and pname == "frequency":
                    # consumed host-side: the integrated phase (a no-op
                    # for noise), not an input
                    wf, _ = osc_ops.parse_waveform(dev.params)
                    if wf != "noise":
                        self._osc_phase[dev.uvid] = \
                            simple_model.oscillator_phase_automated(
                                curve, self.c.n_frames,
                                float(self.c.sample_rate))
                    continue
                self.host_inputs[f"{dev.uvid}/auto/{pname}"] = curve
        self._collect_welsh_merged(welsh_devs)

    # Welsh merge layout: each device buckets its notes by span alone (the
    # reference's default layout; its global one, which no caller sets, is
    # not ported), so every bucket holds one device. The bucket ceiling
    # trades span tightness (wasted samples) against launches; launch_rows
    # weighs a launch as that many rows in bucket_notes' cost.
    WELSH_DEVICE_BUCKETS = 3
    WELSH_LAUNCH_ROWS = 16

    def _collect_welsh_merged(self, devs) -> None:
        """The merged-Welsh inputs (wm/b{j}/{uvid}/...) and plan
        self._wm_plan = [(span, [(uvid, n_rows), ...]), ...]."""
        self._wm_plan: list = []
        if not devs:
            return
        sr = self.c.sample_rate
        h = self.host_inputs
        for d in devs:
            # unison triples the RENDERED notes only
            k, v, on, off, pv = welsh_model.unison_input_notes(
                d.notes, d.voice)
            gate = (off - on).astype(np.int64)
            tail = welsh_model.tail_seconds(d.voice)
            need = gate + int(np.ceil(tail * sr)) + 1
            buckets = bucket_notes(need, self.c.n_frames,
                                   max_buckets=self.WELSH_DEVICE_BUCKETS,
                                   launch_rows=self.WELSH_LAUNCH_ROWS)
            for span, idx in buckets:
                li = np.sort(idx)
                b = f"wm/b{len(self._wm_plan)}/{d.uvid}"
                h[f"{b}/keys"] = k[li]
                h[f"{b}/vels"] = v[li]
                h[f"{b}/on"] = on[li]
                h[f"{b}/gate"] = gate[li].astype(np.int32)
                # note indices within the device (noise keying)
                h[f"{b}/ids"] = li.astype(np.int32)
                if pv is not None:  # glide sources
                    h[f"{b}/prev"] = pv[li]
                hc = welsh_model.host_osc_constants(
                    d.voice, k[li], None if pv is None else pv[li])
                hc.update(welsh_model.host_gate_seconds(gate[li], sr))
                hc.update(welsh_model.host_filter_tables(
                    d.voice, gate[li], int(span), sr))
                php = welsh_model.host_pitch_phases(
                    d.voice, k[li], None if pv is None else pv[li],
                    int(span), sr)
                if php is not None:
                    hc.update(php)
                lvt = welsh_model.host_lfo_table(d.voice, int(span), sr)
                if lvt is not None:
                    hc.update(lvt)
                for name, arr in hc.items():
                    h[f"{b}/hc/{name}"] = arr
                self._wm_plan.append((int(span), [(d.uvid, int(li.size))]))

    def _collect_effect_filters(self) -> None:
        """Host-designed coefficient arrays for every AUTOMATED,
        non-sidechain effect filter (host_effect_filter_coefs)."""
        nb = max(1, -(-self.c.n_frames // BLOCK))
        sr = float(self.c.sample_rate)
        sidechain_targets = {tgt for _, tgt, _ in self.c.sidechain}
        for dev in self.c.devices.values():
            if not dev.kind.startswith("filter-") or not dev.automation \
                    or dev.uvid in sidechain_targets:
                continue
            designed = host_effect_filter_coefs(dev, nb, sr)
            if designed is None:
                continue
            u = dev.uvid
            if designed[0] == "lp24":
                self.host_inputs[f"{u}/fc/gain"] = designed[1]
                self.host_inputs[f"{u}/fc/secs"] = np.stack(
                    [np.stack(sec) for sec in designed[2]])  # [2, 5, nb]
            else:
                self.host_inputs[f"{u}/fc/coefs"] = np.stack(designed[1])

    def _tail_seconds(self, dev: DeviceIR) -> float:
        """How long a note of `dev` sounds past its gate (reference
        :380-392)."""
        if dev.kind in WELSH and dev.voice is not None:
            return welsh_model.tail_seconds(dev.voice)
        if dev.kind == "fm-synthesizer":
            return fm_model.tail_seconds(dev.voice)
        if dev.kind in ("drumkit", "calculator"):
            # one-shots play to the sample end regardless of gate
            return float(dev.sample_table.lengths.max()) / self.c.sample_rate
        if dev.kind == "envelope":
            return float(dev.params.get("release", 0.0))
        return 0.0  # the sampler is gated; other kinds have no tail

    def _collect_instrument(self, dev: DeviceIR) -> None:
        """The host inputs of an instrument outside the merged-Welsh path
        (groove_tpu/engine/render.py:373-470), key for key and bit for
        bit: its note columns, window span, FM span buckets with their
        host frequencies and phase tables, sample tables and ratios, the
        at-rate drumkit's K1 layout, the envelope's host frequencies."""
        notes = dev.notes
        if notes.count == 0:
            return
        sr = self.c.sample_rate
        gate = notes.off_frames - notes.on_frames
        tail = self._tail_seconds(dev)
        span = span_for(int(gate.max()), tail, sr)
        # a window never usefully exceeds the timeline (scatter_notes
        # crops past n_frames)
        span = min(span, -(-self.c.n_frames // 128) * 128)
        u = dev.uvid
        self._spans[u] = span
        h = self.host_inputs
        if dev.kind == "fm-synthesizer" and dev.voice is not None:
            self._collect_fm(dev, gate, tail)
            return
        h[f"{u}/keys"] = notes.keys
        h[f"{u}/vels"] = notes.vels
        h[f"{u}/on"] = notes.on_frames
        h[f"{u}/gate"] = gate.astype(np.int32)
        if dev.kind == "envelope":
            h[f"{u}/hc/f1"] = np.asarray(note_freqs(notes.keys), np.float32)
        if dev.sample_table is None:
            return
        h[f"{u}/table"] = dev.sample_table.data
        h[f"{u}/lengths"] = dev.sample_table.lengths
        h[f"{u}/rates"] = dev.sample_table.rates
        h[f"{u}/slots"] = dev.slots
        if dev.kind == "sampler":
            h[f"{u}/ratios"] = np.asarray(sampler_model.sampler_ratios(
                notes.keys, float(dev.params.get("root", 440.0))),
                np.float32)
        if self._at_rate_kit(dev):
            h[f"{u}/ptable"] = drums.prepare_table(dev.sample_table.data)
            one_shot = np.full(notes.count, 2**30, np.int64)
            meta = drums.prepare_hits(dev.slots, notes.on_frames, one_shot,
                                      notes.vels, dev.sample_table.lengths,
                                      self.c.n_frames)
            for name, arr in zip(("hcounts", "hslots", "hstarts",
                                  "hshifts", "hlimits", "hvels"), meta):
                h[f"{u}/{name}"] = arr

    def _at_rate_kit(self, dev: DeviceIR) -> bool:
        """A drumkit whose every sample is at the song's rate: its hits
        sum straight into the timeline on K1."""
        return dev.kind == "drumkit" and all(
            int(r) == self.c.sample_rate for r in dev.sample_table.rates)

    def _collect_fm(self, dev: DeviceIR, gate, tail: float) -> None:
        """FM's per-device span buckets (a drone must not make every
        short note render a drone-length window): each bucket's note
        columns, its global note ids, host carrier Hz and, without a
        `ratio` curve, host phase tables at the BUCKET's span (reference
        :402-435)."""
        notes = dev.notes
        sr = self.c.sample_rate
        u = dev.uvid
        h = self.host_inputs
        need = gate.astype(np.int64) + int(np.ceil(tail * sr)) + 1
        buckets = bucket_notes(need, self.c.n_frames,
                               launch_rows=self.WELSH_LAUNCH_ROWS)
        self._buckets[u] = [s for s, _ in buckets]
        for j, (bspan, idx) in enumerate(buckets):
            b = f"{u}/b{j}"
            h[f"{b}/keys"] = notes.keys[idx]
            h[f"{b}/vels"] = notes.vels[idx]
            h[f"{b}/on"] = notes.on_frames[idx]
            h[f"{b}/gate"] = gate[idx].astype(np.int32)
            h[f"{b}/ids"] = idx.astype(np.int32)
            h[f"{b}/hc/f1"] = np.asarray(
                note_freqs(np.asarray(notes.keys[idx])), np.float32)
            if "ratio" not in dev.automation:
                php = fm_model.host_phases(dev.voice, notes.keys[idx],
                                           int(bspan), float(sr))
                if php is not None:
                    for nm, arr in php.items():
                        h[f"{b}/hc/{nm}"] = arr

    def _plan_filters(self) -> None:
        self._filter_modes = compute_filter_fidelity(self.c)
        # the Welsh voices' cascade routing: 'refine' (K2) or None (K3)
        sr = float(self.c.sample_rate)
        self._welsh_refine = {
            dev.uvid: welsh_model.filter_fidelity_mode(dev.voice, sr)
            for dev in self.c.devices.values()
            if dev.kind in WELSH and dev.voice is not None
        }

    # ---- the Welsh voices -------------------------------------------------

    def _welsh_jobs(self) -> list:
        """The merged-Welsh render plan in the reference's order, one job
        per span bucket (each holds one device): (kind, bucket, span,
        fidelity, uvid, rows). A "packet" runs its rows through ONE
        cascade launch; a "chunked" bucket is too big for the element cap
        and renders in row chunks of it."""
        cap = self.note_chunk_elems
        jobs = []
        for j, (span, [(uvid, count)]) in enumerate(self._wm_plan):
            kind = "chunked" if count * span > cap else "packet"
            jobs.append((kind, j, span, self._welsh_refine.get(uvid),
                         uvid, count))
        return jobs

    def _chunk_rows(self, count: int, span: int) -> list:
        """Row ranges of a chunked member: as many rows as the cap holds
        (at least one); the last chunk may be short."""
        per = max(1, self.note_chunk_elems // max(span, 1))
        return [(lo, min(lo + per, count)) for lo in range(0, count, per)]

    def welsh_launches(self) -> dict:
        """Cascade launches of one render by the Welsh voices, from the
        plan: K2 ("lp24_refined") for 'refine' jobs, else K3 ("lp24"); a
        packet pays one, a chunked bucket one per chunk."""
        out = {"lp24_refined": 0, "lp24": 0}
        for kind, _j, span, fid, _uvid, count in self._welsh_jobs():
            key = "lp24_refined" if fid else "lp24"
            out[key] += 1 if kind == "packet" \
                else len(self._chunk_rows(count, span))
        return out

    def _render_welsh_merged(self, inputs, n: int, only=None) -> dict:
        """uvid -> mono [n] for every merged Welsh device (or only the
        device `only`, with the same jobs in the same order), job by
        job."""
        monos: dict = {}
        for kind, j, span, fid, uvid, _count in self._welsh_jobs():
            if only is not None and uvid != only:
                continue
            b = f"wm/b{j}/{uvid}"
            mono = self._cascade_packet(inputs, b, uvid, span, fid, n) \
                if kind == "packet" \
                else self._welsh_chunked(inputs, b, uvid, span, fid, n)
            monos[uvid] = monos.get(uvid, self._mono_zeros(n)) + mono
        return monos

    def _hc_for(self, inputs, b: str):
        """A note batch's shipped host-control arrays."""
        prefix = f"{b}/hc/"
        hc = {k[len(prefix):]: v for k, v in inputs.items()
              if k.startswith(prefix)}
        return hc or None

    def _chunked_mono(self, inputs, b: str, span: int, n: int,
                      render) -> torch.Tensor:
        """Render one bucket's notes in row chunks of the cap and sum each
        chunk's scatter into the timeline (the reference's chunk scan;
        its padded last chunk adds exact zeros, a short one here adds
        none). render(lo, hi, hc) -> mono windows [hi - lo, span] of rows
        lo:hi, hc the bucket's host-control arrays with their per-note
        rows cut to lo:hi (tables pass whole)."""
        ctl = self._hc_for(inputs, b) or {}
        on = self._host_on[f"{b}/on"]
        chunks = self._chunk_rows(int(on.shape[0]), span)

        def one(lo: int, hi: int) -> torch.Tensor:
            hc = {k: v[lo:hi] if k in welsh_model.HOST_CTL_PER_NOTE else v
                  for k, v in ctl.items()}
            with profiling.span("voices"):
                windows = render(lo, hi, hc or None)
            with profiling.span("scatter"):
                return scatter_notes(windows, on[lo:hi], n)

        if len(chunks) == 1:
            return one(*chunks[0])
        mono = self._mono_zeros(n)
        for lo, hi in chunks:
            mono = mono + one(lo, hi)
        return mono

    def _welsh_chunked(self, inputs, b: str, uvid: str, span: int, fid,
                       n: int) -> torch.Tensor:
        """A Welsh bucket over the cap: whole render_notes per chunk."""
        voice = self.c.devices[uvid].voice
        sr = float(self.c.sample_rate)
        prev = inputs.get(f"{b}/prev")

        def render(lo: int, hi: int, hc) -> torch.Tensor:
            return welsh_model.render_notes(
                voice, inputs[f"{b}/keys"][lo:hi],
                inputs[f"{b}/vels"][lo:hi], inputs[f"{b}/gate"][lo:hi],
                span, sr, refine_filter=fid,
                note_ids=inputs[f"{b}/ids"][lo:hi],
                prev_keys=None if prev is None else prev[lo:hi],
                host_ctl=hc)

        return self._chunked_mono(inputs, b, span, n, render)

    def _cascade_packet(self, inputs, b: str, uvid: str, span: int, fid,
                        n: int) -> torch.Tensor:
        """One bucket's notes: render_notes_parts, ONE cascade launch over
        all its rows, then the windows times their amp scattered into a
        mono timeline."""
        sr = float(self.c.sample_rate)
        with profiling.span("voices", uvid=uvid):
            osc, filt, amp = welsh_model.render_notes_parts(
                self.c.devices[uvid].voice, inputs[f"{b}/keys"],
                inputs[f"{b}/vels"], inputs[f"{b}/gate"], span, sr,
                note_ids=inputs[f"{b}/ids"],
                prev_keys=inputs.get(f"{b}/prev"),
                host_ctl=self._hc_for(inputs, b))
        with profiling.span("cascade", uvid=uvid):
            y = welsh_model.apply_cascade(osc, filt, sr, fidelity=fid)
        with profiling.span("scatter", uvid=uvid):
            return scatter_notes(y * amp, self._host_on[f"{b}/on"], n)

    # ---- render -------------------------------------------------------------

    def _param(self, inputs, dev: DeviceIR, name: str, default: float,
               n: int, override=None):
        """Per-sample [n] tensor if automated/overridden, else a float."""
        if override is not None:
            return override
        key = f"{dev.uvid}/auto/{name}"
        if key in inputs:
            return _upsample_block(inputs[key], n)
        return float(dev.params.get(name, default))

    def _zeros(self, n: int) -> torch.Tensor:
        return torch.zeros((2, n), dtype=torch.float32, device=self.device)

    def _mono_zeros(self, n: int) -> torch.Tensor:
        return torch.zeros((n,), dtype=torch.float32, device=self.device)

    def _render_instrument(self, inputs, dev: DeviceIR, n: int,
                           welsh_monos: dict | None = None):
        """One instrument -> stereo [2, n] (groove_tpu/engine/render.py:
        675-816). Without welsh_monos (an instrument rendered on its own:
        utils/profiling, utils/spectrum, the service's isolated render) a
        Welsh device renders its own merged jobs."""
        if dev.kind == "oscillator":
            mono = self._render_oscillator(dev, n)
            return torch.stack([mono, mono])
        if dev.kind == "toy-instrument":
            mono = simple_model.toy_instrument(
                float(dev.params.get("fake-value", 0.0)), n, self.device)
            return torch.stack([mono, mono])
        if dev.notes is None or dev.notes.count == 0:
            return self._zeros(n)
        u = dev.uvid
        if dev.kind in WELSH or dev.kind == "fm-synthesizer":
            if dev.voice is None:
                return self._zeros(n)
            if dev.kind == "fm-synthesizer":
                mono = self._render_fm(inputs, dev, n)
                left, right = pan_gains(
                    self._param(inputs, dev, "pan", dev.voice.pan, n),
                    self.device)
                g = self._param(inputs, dev, "gain", dev.voice.gain, n)
                return torch.stack([mono * left * g, mono * right * g])
            if welsh_monos is None:
                welsh_monos = self._render_welsh_merged(inputs, n, only=u)
            mono = welsh_monos.get(u, self._mono_zeros(n))
            # the voice DCA (centre pan) then the synth DCA with its
            # pan/gain automation
            lv, rv = pan_gains(0.0, self.device)
            ls, rs = pan_gains(self._param(inputs, dev, "pan", 0.0, n),
                               self.device)
            g = self._param(inputs, dev, "gain", 1.0, n)
            return torch.stack([mono * lv * ls * g, mono * rv * rs * g])
        sr = float(self.c.sample_rate)
        span = self._spans[u]
        on = self._host_on[f"{u}/on"]
        if dev.kind in ("drumkit", "sampler", "calculator"):
            if self._at_rate_kit(dev):
                return drums.accumulate_hits(
                    inputs[f"{u}/ptable"], inputs[f"{u}/hcounts"],
                    inputs[f"{u}/hslots"], inputs[f"{u}/hstarts"],
                    inputs[f"{u}/hshifts"], inputs[f"{u}/hlimits"],
                    inputs[f"{u}/hvels"], n_frames=n)
            gate = inputs[f"{u}/gate"]
            if dev.kind == "sampler":
                ratios = inputs[f"{u}/ratios"]
            else:
                gate = torch.full_like(gate, span)  # one-shot
                ratios = inputs.get(f"{u}/ratios")
                if ratios is None:
                    ratios = torch.ones(dev.notes.count, dtype=torch.float32,
                                        device=self.device)
            stereo_notes = sampler_model.render_notes(
                inputs[f"{u}/table"], inputs[f"{u}/lengths"],
                inputs[f"{u}/rates"], inputs[f"{u}/slots"], ratios, gate,
                inputs[f"{u}/vels"], span, sr)
            return scatter_notes(stereo_notes, on, n)
        if dev.kind == "envelope":
            adsr = (float(dev.params.get("attack", 0.0)),
                    float(dev.params.get("decay", 0.0)),
                    float(dev.params.get("sustain", 1.0)),
                    float(dev.params.get("release", 0.0)))
            mono_notes = simple_model.envelope_instrument(
                adsr, inputs[f"{u}/keys"], inputs[f"{u}/vels"],
                inputs[f"{u}/gate"], span, sr,
                freqs=inputs.get(f"{u}/hc/f1"))
            mono = scatter_notes(mono_notes, on, n)
            return torch.stack([mono, mono])
        warn(f"unknown instrument kind {dev.kind}; silent")
        return self._zeros(n)

    def _render_oscillator(self, dev: DeviceIR, n: int) -> torch.Tensor:
        """The always-on oscillator -> mono [n]: the integrated host phase
        of an automated frequency (a no-op for noise), else the static
        frequency on the host time base; noise from ops/prng.py."""
        sr = float(self.c.sample_rate)
        wf, pw = osc_ops.parse_waveform(dev.params)
        if dev.uvid in self._consts:
            phase = self._consts[dev.uvid]
            return osc_ops.pulse_width(phase, pw) if wf == "pulse-width" \
                else osc_ops.evaluate(wf, phase)
        freq = float(dev.params.get("frequency", 440.0))
        if wf == "pulse-width":
            t = time_base(n, sr, self.device)
            return osc_ops.pulse_width(freq * t, pw)
        return simple_model.oscillator_instrument(wf, freq, n, sr,
                                                  device=self.device)

    def _render_fm(self, inputs, dev: DeviceIR, n: int) -> torch.Tensor:
        """One FM device -> mono [n]: each span bucket in row chunks of the
        cap (_chunked_mono), its ratio/depth/beta automation sliced at
        each note's absolute position, the host carrier Hz and phase
        tables where shipped."""
        u = dev.uvid
        sr = float(self.c.sample_rate)
        ac = {nm: inputs[f"{u}/auto/{nm}"] for nm in ("ratio", "depth", "beta")
              if f"{u}/auto/{nm}" in inputs}
        mono = self._mono_zeros(n)
        for j, span in enumerate(self._buckets[u]):
            b = f"{u}/b{j}"
            # the note-on frames on the device: uploading the host copy
            # would wait for the device's queue
            on = inputs[f"{b}/on"]

            def render(lo: int, hi: int, hc, b=b, span=span, on=on):
                return fm_model.render_notes(
                    dev.voice, inputs[f"{b}/keys"][lo:hi],
                    inputs[f"{b}/vels"][lo:hi], inputs[f"{b}/gate"][lo:hi],
                    span, sr, on_frames=on[lo:hi], ratio_b=ac.get("ratio"),
                    depth_b=ac.get("depth"), beta_b=ac.get("beta"),
                    freqs=None if hc is None else hc.get("f1"),
                    phases=hc if hc and "phm" in hc else None)

            mono = mono + self._chunked_mono(inputs, b, span, n, render)
        return mono

    def fm_launches(self) -> dict:
        """scan1 launches of one render by the FM voices, from the plan:
        a device with a `ratio` curve integrates its modulator phase in
        each chunk of each bucket (fm.phase_scans launches)."""
        count = 0
        for u, spans in self._buckets.items():
            if "ratio" not in self.c.devices[u].automation:
                continue
            for j, span in enumerate(spans):
                rows = int(self._host_on[f"{u}/b{j}/on"].shape[0])
                count += fm_model.phase_scans(span) \
                    * len(self._chunk_rows(rows, span))
        return {"scan1": count}

    def _apply_effect(self, inputs, dev: DeviceIR, x, n: int, overrides):
        k = dev.kind

        def P(name, default):
            return self._param(inputs, dev, name, default, n,
                               override=overrides.get((dev.uvid, name)))

        if k == "mixer" or k == "signal-passthrough-controller":
            return x
        if k == "gain":
            return effects.gain(x, P("ceiling", 1.0))
        if k == "limiter":
            return effects.limiter(x, P("minimum", 0.0), P("maximum", 1.0))
        if k == "bitcrusher":
            bits = overrides.get((dev.uvid, "bits-to-crush"))
            if bits is None:
                key = f"{dev.uvid}/auto/bits-to-crush"
                if key in inputs:
                    bits = _upsample_block(inputs[key], n)
                else:
                    bits = float(dev.params.get("bits", 8))
            return effects.bitcrusher(x, bits)
        if k == "compressor":
            return self._apply_compressor(dev, x, overrides, P)
        if k == "delay":
            return self._apply_delay(inputs, dev, x, overrides)
        if k == "chorus":
            return self._apply_chorus(inputs, dev, x, overrides, P)
        if k == "reverb":
            return self._apply_reverb(inputs, dev, x, overrides, P)
        if k == "toy":
            return simple_model.toy_effect(x)
        if k.startswith("filter-"):
            return self._apply_filter(inputs, dev, x, overrides)
        warn(f"unknown effect kind {k}; passthrough")
        return x

    def _apply_compressor(self, dev: DeviceIR, x, overrides, P):
        """Instantaneous at attack = release = 0 (static), else the
        smoothed follower (groove_tpu/engine/render.py:840-858).
        Sidechain-driven seconds clamp to SIDECHAIN_SECONDS_MAX."""
        sr = float(self.c.sample_rate)
        thr = P("threshold", 1.0)
        ratio = P("ratio", 1.0)
        att = overrides.get((dev.uvid, "attack"))
        att = (torch.clamp(att, 0.0, SIDECHAIN_SECONDS_MAX)
               if att is not None else P("attack", 0.0))
        rel = overrides.get((dev.uvid, "release"))
        rel = (torch.clamp(rel, 0.0, SIDECHAIN_SECONDS_MAX)
               if rel is not None else P("release", 0.0))
        if isinstance(att, float) and isinstance(rel, float) \
                and att <= 0.0 and rel <= 0.0:
            return dynamics.compressor(x, thr, ratio)
        return dynamics.compressor_smoothed(x, thr, ratio, att, rel, sr)

    def _apply_delay(self, inputs, dev: DeviceIR, x, overrides):
        """A sidechain override (a 64-sample hold: [::BLOCK] recovers its
        block-rate curve) wins over a trip; either gathers per-block taps
        (render.py:859-873)."""
        sr = float(self.c.sample_rate)
        ov = overrides.get((dev.uvid, "delay"))
        if ov is not None:
            return delayfx.delay_automated(
                x, torch.clamp(ov[::BLOCK], 0.0, SIDECHAIN_SECONDS_MAX), sr)
        key = f"{dev.uvid}/auto/delay"
        if key in inputs:
            return delayfx.delay_automated(x, inputs[key], sr)
        return delayfx.delay(x, float(dev.params.get("delay", 0.0)), sr)

    def _apply_chorus(self, inputs, dev: DeviceIR, x, overrides, P):
        """Automated total delay and/or tap count: per-block gather taps,
        the tap loop bounded by the voices curve's host maximum for a trip,
        the configured static count for a sidechain (render.py:874-910)."""
        sr = float(self.c.sample_rate)
        u = dev.uvid
        dkey, vkey = f"{u}/auto/delay-seconds", f"{u}/auto/voices"
        ov_d = overrides.get((u, "delay-seconds"))
        ov_v = overrides.get((u, "voices"))
        voices = int(dev.params.get("voices", 1))
        if ov_d is None and ov_v is None and dkey not in inputs \
                and vkey not in inputs:
            return delayfx.chorus(
                x, voices, float(dev.params.get("delay-seconds", 0.0)), sr,
                wet_dry_mix=P("wet-dry-mix", 1.0))
        if ov_v is not None:
            voices_b, maxv = ov_v[::BLOCK], max(1, voices)
        elif vkey in inputs:
            voices_b = inputs[vkey]
            maxv = delayfx.chorus_curve_max_voices(dev.automation["voices"])
        else:
            voices_b, maxv = None, None
        if ov_d is not None:
            delay_b = torch.clamp(ov_d[::BLOCK], 0.0, SIDECHAIN_SECONDS_MAX)
        elif dkey in inputs:
            delay_b = inputs[dkey]
        else:
            delay_b = float(dev.params.get("delay-seconds", 0.0))
        return delayfx.chorus_automated(
            x, voices, delay_b, sr, wet_dry_mix=P("wet-dry-mix", 1.0),
            voices_b=voices_b, max_voices=maxv)

    def _apply_reverb(self, inputs, dev: DeviceIR, x, overrides, P):
        """attenuation is a per-sample output gain; `seconds` drives the
        comb gains at block cadence when automated or sidechain-driven
        (render.py:911-928)."""
        sr = float(self.c.sample_rate)
        ov = overrides.get((dev.uvid, "seconds"))
        key = f"{dev.uvid}/auto/seconds"
        if ov is not None or key in inputs:
            seconds_b = ov[::BLOCK] if ov is not None else inputs[key]
            return delayfx.reverb_automated(x, P("attenuation", 1.0),
                                            seconds_b, sr)
        return delayfx.reverb(x, P("attenuation", 1.0),
                              float(dev.params.get("seconds", 0.0)), sr)

    def _apply_filter(self, inputs, dev: DeviceIR, x, overrides):
        """Every filter-* effect, at the reference's 64-frame control
        cadence (groove_tpu/engine/render.py:931-1001)."""
        k = dev.kind
        u = dev.uvid
        sr = float(self.c.sample_rate)
        fidelity = self._filter_modes.get(u)
        # automated filters: HOST-designed coefficient arrays
        # (_collect_effect_filters) — backend-independent bits
        if f"{u}/fc/secs" in inputs:
            fs = inputs[f"{u}/fc/secs"]
            return iir.lp24_apply_blockrate_sections(
                x, inputs[f"{u}/fc/gain"],
                [tuple(fs[i, j] for j in range(5)) for i in range(2)],
                fidelity=fidelity)
        if f"{u}/fc/coefs" in inputs:
            co = inputs[f"{u}/fc/coefs"]
            return iir.biquad_blockrate(x, tuple(co[j] for j in range(5)),
                                        fidelity=fidelity)

        def PB(name, default):
            ov = overrides.get((u, name))
            if ov is not None:
                # per-sample override is a 64-sample hold: the first
                # sample of each block recovers the block value, and
                # [::BLOCK] has exactly ceil(n/BLOCK) entries
                return ov[::BLOCK]
            key = f"{u}/auto/{name}"
            if key in inputs:
                return inputs[key]
            return float(dev.params.get(name, default))

        def fmax(v, lo):
            # a static param stays a Python float: its design runs on the
            # host in numpy (backend-independent bits); a tensor (the
            # sidechain's values) designs on the device
            return max(v, lo) if isinstance(v, float) \
                else torch.clamp_min(v, lo)

        cutoff = PB("cutoff", 1000.0)
        if k == "filter-low-pass-24db":
            q = PB("passband-ripple", 0.707)
            return iir.lp24_apply_blockrate(x, cutoff, fmax(q, 1e-3), sr,
                                            fidelity=fidelity)
        if k == "filter-low-pass-12db":
            coefs = iir.rbj_low_pass(cutoff, fmax(PB("q", 0.707), 1e-3), sr)
        elif k == "filter-high-pass-12db":
            coefs = iir.rbj_high_pass(cutoff, fmax(PB("q", 0.707), 1e-3), sr)
        elif k == "filter-all-pass-12db":
            coefs = iir.rbj_all_pass(cutoff, fmax(PB("q", 0.707), 1e-3), sr)
        elif k == "filter-band-pass-12db":
            coefs = iir.rbj_band_pass(
                cutoff, fmax(PB("bandwidth", 1.0), 1e-3), sr)
        elif k == "filter-band-stop-12db":
            coefs = iir.rbj_band_stop(
                cutoff, fmax(PB("bandwidth", 1.0), 1e-3), sr)
        elif k == "filter-peaking-eq-12db":
            coefs = iir.rbj_peaking_eq(
                cutoff, fmax(PB("q", 1.0), 1e-3), PB("db-gain", 0.0), sr)
        elif k == "filter-low-shelf-12db":
            coefs = iir.rbj_low_shelf(cutoff, PB("db-gain", 0.0), sr)
        elif k == "filter-high-shelf-12db":
            coefs = iir.rbj_high_shelf(cutoff, PB("db-gain", 0.0), sr)
        else:
            warn(f"unknown filter kind {k}; passthrough")
            return x
        return iir.biquad_blockrate(x, coefs, fidelity=fidelity)

    def _render(self, inputs) -> torch.Tensor:
        c = self.c
        n = c.n_frames
        outputs: dict[str, torch.Tensor] = {}
        overrides: dict[tuple, torch.Tensor] = {}
        sidechain_by_src: dict = {}
        for src, tgt, pname in c.sidechain:
            sidechain_by_src.setdefault(src, []).append((tgt, pname))
        sends_by_aux: dict = {}
        for src, aux, amount in c.sends:
            sends_by_aux.setdefault(aux, []).append((src, amount))

        if self._wm_plan:
            with profiling.span("instrument", kind="welsh"):
                welsh_monos = self._render_welsh_merged(inputs, n)
        else:
            welsh_monos = {}
        for uvid in c.order:
            dev = c.devices[uvid]
            if dev.role == "instrument" or dev.kind == "calculator":
                with profiling.span("instrument", kind=dev.kind, uvid=uvid):
                    outputs[uvid] = self._render_instrument(
                        inputs, dev, n, welsh_monos)
                continue
            with profiling.span("mix", uvid=uvid):
                acc = self._zeros(n)
                for s in c.sinks.get(uvid, []):
                    if s in outputs:
                        acc = acc + outputs[s]
                for s, amount in sends_by_aux.get(uvid, []):
                    if s in outputs:
                        acc = acc + amount * outputs[s]  # BusRoute send
            if dev.role == "controller" \
                    and dev.kind != "signal-passthrough-controller":
                continue  # non-audio controllers have no audio output
            with profiling.span("effect", kind=dev.kind, uvid=uvid):
                outputs[uvid] = self._apply_effect(inputs, dev, acc, n,
                                                   overrides)
            if uvid in sidechain_by_src:
                with profiling.span("mix", kind="sidechain", uvid=uvid):
                    # last sample of block b-1 -> control value for
                    # block b
                    last = acc[:, BLOCK - 1::BLOCK]
                    val = torch.abs(torch.mean(last, dim=0))
                    val = torch.cat([torch.zeros(1, dtype=val.dtype,
                                                 device=val.device),
                                     val[:-1]])
                    per_sample = _upsample_block(val, n)
                    for tgt, pname in sidechain_by_src[uvid]:
                        p = param_mod.resolve(c.devices[tgt].kind, pname)
                        overrides[(tgt, pname)] = (
                            param_mod.to_domain_array(p, per_sample)
                            if p is not None else per_sample)

        out = outputs.get(MAIN_MIXER_UVID, self._zeros(n))
        return out.T  # [n, 2]

    # ---- public -------------------------------------------------------------

    # Each of the three opens the root span "render": the graph's enqueue
    # ("graph"), then render_quantized's "quantize" and the fetch, where
    # the host waits for the card ("fetch", a host sync, and one of the
    # counters "fetch_pinned" and "fetch_pageable").

    def _graph(self) -> torch.Tensor:
        with profiling.span("graph"):
            return self._render(self.inputs)

    def _fetch(self, y: torch.Tensor) -> np.ndarray:
        """y on the host as its own array. A card's y is copied into
        page-locked memory from torch's host cache with y's strides (one
        DMA, the layout of y.cpu().numpy()) and the host waits once for
        the current stream; the block goes back to the cache when the
        caller drops the array. A host tensor, or a card's y when no
        page-locked memory can be had, is read as y.cpu().numpy()."""
        with profiling.span("fetch", bytes=y.nbytes):
            host = _pinned_like(y) if y.is_cuda else None
            if host is None:
                profiling.count("fetch_pageable")
                return profiling.host_sync(y)
            profiling.count("fetch_pinned")
            host.copy_(y, non_blocking=True)
            profiling.host_sync(torch.cuda.current_stream(y.device),
                                torch.cuda.Stream.synchronize)
            return host.numpy()

    def render_device(self) -> torch.Tensor:
        """Device-resident float render [n, 2] (no host copy)."""
        with profiling.span("render", frames=self.c.n_frames):
            return self._graph()

    def render(self) -> np.ndarray:
        """Float render [n, 2] on the host."""
        if self.c.n_frames == 0:
            return np.zeros((0, 2), np.float32)
        with profiling.span("render", frames=self.c.n_frames):
            return self._fetch(self._graph())

    def render_quantized(self) -> np.ndarray:
        """int16 render [n, 2], quantized on the device (io.wav spec)."""
        if self.c.n_frames == 0:
            return np.zeros((0, 2), np.int16)
        with profiling.span("render", frames=self.c.n_frames):
            y = self._graph()
            with profiling.span("quantize"):
                q = quantize_16bit(y)
            return self._fetch(q)
