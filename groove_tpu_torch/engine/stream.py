"""Segment-streamed render and loop-range playback (port of
groove_tpu/engine/stream.py).

The song renders in fixed-size segments (a multiple of 64 frames) through
one step function with explicitly carried state — filter states,
delay-line tails, follower states, the sidechain's one-block value, the
sliced Welsh notes' cascade states — so device memory is bounded by the
segment size plus the state, whatever the song's length (always-on
oscillator tracks are host data, shipped a segment at a time; block-rate
automation curves and host-designed filter tables stay on the device at
1/64 of the frame count). Segment boundaries are invisible in the output:
every stateful effect comes from ops/stream.py, whose recurrences run on
grids fixed in song time (the carried-state kernels S1-S4 of
ops/stream_kernels.py), so rendering the song as ONE segment and as MANY
segments is bit-identical (tests/test_torch_stream.py, chip_smoke.py).

Instruments render every note that overlaps a segment as its whole
window (the reference's default), then add the segment's part of it:
Welsh voices through welsh.render_notes (the cascade on K2 or K3), FM
voices through fm.render_notes (a `ratio` curve's modulator phase on
scan1, its chunk fixed by the bucket's span), drumkits and the
calculator at the song's rate as aligned row copies
(sampler.render_notes_aligned), the sampler and other rates resampled,
the envelope instrument as sine windows; the oscillator plays its host
track's slice and the toy instrument its constant. Notes are grouped in
span buckets (models/voices.bucket_notes); a bucket's batch per segment
is padded to its capacity (the most notes overlapping any segment), its
padded rows masked to exact zeros, and its windows are summed into the
segment one note after another, so a note's contribution never depends on
which other rows share its batch.

Sliced Welsh voices (WELSH_SLICED True, or "auto" where _slice_wins):
each segment renders exactly its slice of every active note, carrying
each note's cascade state from segment to segment in the stream kernels
K7 and K8. They stream linearly only: a loop's seek rewinds note ages,
which the carried note state cannot follow.

Loop-range playback (stream_loop) rides the same step: [0, loop_end),
then [loop_start, loop_end) repeatedly, with all state carried across
the seam like the reference's clock seek; loop boundaries quantize to the
64-frame grid. Notes gated past the loop end truncate at the seam.

Not ported: the reference's WELSH_SLICE_MERGE (one merged cascade launch
for every sliced bucket of a segment), off by default there.
"""

from __future__ import annotations

from collections import deque
from fractions import Fraction

import numpy as np
import torch

from groove_tpu_torch.compiler import params as param_mod
from groove_tpu_torch.compiler.song import CompiledSong, DeviceIR, \
    MAIN_MIXER_UVID
from groove_tpu_torch.core.time import SAMPLE_BUFFER_SIZE, SampleRate, \
    Tempo, beats_to_frames
from groove_tpu_torch.engine.params import inputs_from_numpy
from groove_tpu_torch.engine.render import (SIDECHAIN_SECONDS_MAX,
                                            compute_filter_fidelity,
                                            host_effect_filter_coefs,
                                            warn_static_only)
from groove_tpu_torch.io.wav import quantize_16bit
from groove_tpu_torch.models import fm as fm_model
from groove_tpu_torch.models import sampler as sampler_model
from groove_tpu_torch.models import simple as simple_model
from groove_tpu_torch.models import welsh as welsh_model
from groove_tpu_torch.models.voices import (bucket_notes, note_freqs,
                                            scatter_notes, time_base)
from groove_tpu_torch.ops import delayfx, dynamics, effects, iir, prng
from groove_tpu_torch.ops import oscillator as osc_ops
from groove_tpu_torch.ops import stream as sops
from groove_tpu_torch.ops.dca import pan_gains
from groove_tpu_torch.ops.iir_kernels import as_f32, is_scalar
from groove_tpu_torch.project.schema import warn

BLOCK = SAMPLE_BUFFER_SIZE  # 64
WELSH = ("welsh", "welsh-raw")
# state layout -> the stream kernel that carries it (iir_kernels.LAUNCHES)
STATE_KERNEL = {"p4": "lp24_stream", "p20": "lp24_refined_stream"}
REFINED_KEYS = ("ss1", "ss2", "cs1", "cs2", "xh", "yh", "ch")


def _fmax(v, lo):
    """max(v, lo): a number stays a number (its design runs on the host),
    a tensor (a sidechain's values) is clamped on its device."""
    return max(v, lo) if isinstance(v, float) else torch.clamp_min(v, lo)


def _round_block(frames) -> int:
    return -(-int(frames) // BLOCK) * BLOCK


def channel_symmetric(c: "CompiledSong") -> bool:
    """Conservative static proof that a compiled song renders L == R
    BITWISE, enabling the streamed mono fold (half the fetched bytes).

    Every op applies identical per-channel math, so the only asymmetry
    sources are (checked per device): a nonzero pan (device param or the
    voice's DCA pan); pan under automation or driven by a sidechain link;
    a sample table whose channels differ. Anything not provably centred
    returns False (stereo fetch). The fold also fetches a device-computed
    tripwire flag, so a wrong True raises instead of corrupting audio.
    (A copy of the reference's function.)"""
    import numpy as np

    for dev in c.devices.values():
        if "pan" in dev.automation:
            return False
        default_pan = getattr(dev.voice, "pan", 0.0) \
            if dev.voice is not None else 0.0
        try:
            if float(dev.params.get("pan", default_pan)) != 0.0:
                return False
        except (TypeError, ValueError):
            return False
        st = getattr(dev, "sample_table", None)
        if st is not None and not np.array_equal(st.data[:, 0],
                                                 st.data[:, 1]):
            return False
    if any(p == "pan" for _, _, p in c.sidechain):
        return False
    return True


def _fold_mono_f32(audio: torch.Tensor) -> torch.Tensor:
    """[.., 2] f32 -> flat [N+1] mono with a trailing tripwire element
    (1.0 iff any sample pair differs in its BIT pattern)."""
    a = audio.reshape(-1, 2)
    bits = a.view(torch.int32)
    flag = torch.any(bits[:, 0] != bits[:, 1]).to(a.dtype)
    return torch.cat([a[:, 0], flag[None]])


def _fold_mono_i16(audio: torch.Tensor) -> torch.Tensor:
    """[.., 2] f32 -> device-quantized flat [N+1] int16 mono + tripwire
    (comparing the QUANTIZED channels: flag == 0 certifies the emitted
    bytes equal the stereo fetch's)."""
    q = quantize_16bit(audio.reshape(-1, 2))
    flag = torch.any(q[:, 0] != q[:, 1]).to(torch.int16)
    return torch.cat([q[:, 0], flag[None]])


def _unfold_mono(arr):
    """Host side of the fold: verify the tripwire, duplicate to [N, 2]."""
    import numpy as np

    if arr[-1]:
        raise RuntimeError(
            "mono-fold tripwire: the device reports channel asymmetry in "
            "a graph channel_symmetric() proved symmetric — analysis bug, "
            "please report (disable with mono_fold=False)")
    mono = arr[:-1]
    return np.repeat(mono[:, None], 2, axis=1)


def _row_sum(rows: torch.Tensor) -> torch.Tensor:
    """Sum of [m, n] rows in row order, one add after another: a padded
    (exact-zero) row never regroups the others, so the sum is the same
    whatever the batch's padding, on every device."""
    acc = rows[0]
    for i in range(1, rows.shape[0]):
        acc = acc + rows[i]
    return acc


class StreamingRenderer:
    """Segment-streamed render of one compiled song on one torch device.

    segment_frames must be a multiple of 64 and at least 64. inputs:
    optional host (numpy) input dict to render from instead of this
    renderer's own collection — e.g. groove_tpu's StreamingRenderer.inputs
    converted to numpy (engine/params.inputs_from_numpy).
    """

    # SLICED welsh mode: False (every note renders its whole window per
    # overlapping segment — the reference's default) | True (force every
    # sliceable device — the bitwise test configuration) | "auto" (route
    # per device by the work model in _slice_wins — the CLI --sliced
    # configuration).
    WELSH_SLICED = False

    # Per-sample cost of the sliced stateful cascade RELATIVE to the
    # unsliced whole-window path, the _slice_wins work model's one
    # constant. CPU: the reference's CPU calibration. CUDA: measured on an
    # NVIDIA H100 80GB HBM3 at 700.00 W (python -m
    # groove_tpu_torch.slice_cost: the 3-minute Welsh analogue streamed
    # forced-sliced and unsliced, steady seconds): at 16384-frame segments
    # 3.78 s sliced against 5.10 s unsliced, c_eff = 4.63; at 65536 0.974
    # s against 1.248 s, c_eff = 1.41. 6.0 is the larger fit times 1.3 for
    # the per-segment costs the model leaves out (batch assembly, state
    # traffic), so "auto" leans toward whole windows and never routes a
    # measured loss.
    SLICE_COST_CPU = 2.0
    SLICE_COST_CUDA = 6.0

    def __init__(self, compiled: CompiledSong, device,
                 segment_frames: int = 65536, inputs=None):
        if segment_frames % BLOCK or segment_frames < BLOCK:
            raise ValueError(f"segment_frames must be a positive multiple "
                             f"of {BLOCK}, got {segment_frames}")
        self.c = compiled
        self.device = torch.device(device)
        self.S = int(segment_frames)
        self.n_segs = max(1, -(-compiled.n_frames // self.S))
        self.plan_frames = self.n_segs * self.S
        self.host_inputs: dict[str, np.ndarray] = {}
        # per-device span buckets: _spans[u] the bucket spans,
        # _bucket_on[u][j] the bucket's note-on frames; caps per (u, j)
        self._spans: dict[str, list[int]] = {}
        self._bucket_on: dict[str, list[np.ndarray]] = {}
        self._caps: dict[tuple[str, int], int] = {}
        # host-resident whole-plan oscillator tracks, sliced per segment
        self._osc_tracks: dict[str, np.ndarray] = {}
        self._warned: set = set()
        self._filter_modes = compute_filter_fidelity(compiled)
        self._welsh_refine = {
            dev.uvid: welsh_model.filter_fidelity_mode(
                dev.voice, float(compiled.sample_rate))
            for dev in compiled.devices.values()
            if dev.kind in WELSH and dev.voice is not None
        }
        self._sliced = {
            dev.uvid
            for dev in compiled.devices.values()
            if self.WELSH_SLICED
            and dev.kind in WELSH
            and dev.voice is not None
            and dev.notes is not None and dev.notes.count
            and welsh_model.can_slice(dev.voice)
            and (self.WELSH_SLICED != "auto" or self._slice_wins(dev))
        }
        self.mono_foldable = channel_symmetric(compiled)
        self._collect_inputs()
        source = self.host_inputs if inputs is None else inputs
        # note-on frames stay on the host too: the segment's scatter of
        # whole windows places them without waiting for the device
        self._host_on = {k: np.asarray(v) for k, v in source.items()
                         if k.endswith("/on")}
        self.inputs = inputs_from_numpy(source, self.device)
        self._noise_keys = self._bucket_noise_keys()

    # ---- host-side collection ---------------------------------------------

    def _slice_cost(self) -> float:
        return (self.SLICE_COST_CPU if self.device.type == "cpu"
                else self.SLICE_COST_CUDA)

    def _slice_wins(self, dev: DeviceIR) -> bool:
        """Per-device routing for the sliced mode: slicing renders
        [active_notes, S] per segment and wins only when the segment is
        short relative to the device's note windows. Compare per-segment
        work: sliced ~ cap * S vs unsliced ~ sum over overlapping notes of
        their full spans, the sliced side weighted by _slice_cost."""
        on = np.asarray(dev.notes.on_frames, np.int64)
        off = np.asarray(dev.notes.off_frames, np.int64)
        tail = int(np.ceil(self._note_tail(dev) * self.c.sample_rate))
        span = np.minimum((off - on) + tail + 1, self.c.n_frames)
        # expected overlapping-note work per segment (window recompute):
        # each note is re-rendered in ceil((span + S) / S) segments
        unsliced = float(np.sum(span * np.ceil((span + self.S) / self.S)))
        # sliced work: sum over segments of active-note count x S
        # ~= sum over notes of (span + S)  (each note active that long),
        # weighted by the kernel's calibrated relative cost
        sliced = self._slice_cost() * float(np.sum(span + self.S))
        return sliced < unsliced

    def _note_tail(self, dev: DeviceIR) -> float:
        """How long a note of `dev` sounds past its gate."""
        sr = self.c.sample_rate
        if dev.kind in WELSH and dev.voice is not None:
            return welsh_model.tail_seconds(dev.voice)
        if dev.kind == "fm-synthesizer":
            return fm_model.tail_seconds(dev.voice)
        if dev.kind in ("drumkit", "calculator"):
            return float(dev.sample_table.lengths.max()) / sr
        if dev.kind == "envelope":
            return float(dev.params.get("release", 0.0))
        return 0.0

    def _note_buckets(self, dev: DeviceIR, on, off) -> list:
        """Span buckets [(span, note_indices)] for one instrument's notes
        on/off (unison-tripled for welsh), spans cropped to the
        timeline."""
        sr = self.c.sample_rate
        gate = (off - on).astype(np.int64)
        tail = self._note_tail(dev)
        need = gate + int(np.ceil(tail * sr)) + 1
        return bucket_notes(need, self.c.n_frames)

    def _oscillator_track(self, dev: DeviceIR) -> np.ndarray:
        """The always-on oscillator over the whole plan, on this
        renderer's device, as a host array: an automated frequency's
        integrated host phase (a no-op for noise), else the static
        frequency on the host time base; noise from ops/prng.py."""
        sr = float(self.c.sample_rate)
        n = self.plan_frames
        wf, pw = osc_ops.parse_waveform(dev.params)
        freq = float(dev.params.get("frequency", 440.0))
        if "frequency" in dev.automation and wf != "noise":
            phase = torch.from_numpy(simple_model.oscillator_phase_automated(
                dev.automation["frequency"], n, sr)).to(self.device)
            mono = osc_ops.pulse_width(phase, pw) if wf == "pulse-width" \
                else osc_ops.evaluate(str(wf), phase)
        elif wf == "pulse-width":
            mono = osc_ops.pulse_width(freq * time_base(n, sr, self.device),
                                       pw)
        else:
            mono = simple_model.oscillator_instrument(str(wf), freq, n, sr,
                                                      device=self.device)
        return mono.cpu().numpy()

    def _collect_inputs(self) -> None:
        """The host inputs, key for key and bit for bit groove_tpu's
        StreamingRenderer.inputs (groove_tpu/engine/stream.py:332-549)."""
        c = self.c
        sr = float(c.sample_rate)
        nb_plan = self.plan_frames // BLOCK
        h = self.host_inputs
        sidechain_targets = {tgt for _, tgt, _ in c.sidechain}
        for dev in c.devices.values():
            u = dev.uvid
            warn_static_only(dev)
            if dev.kind.startswith("filter-") and dev.automation \
                    and u not in sidechain_targets:
                # host-designed whole-plan coefficient tables: the step
                # slices the segment's blocks, the same constants at
                # every segmentation
                designed = host_effect_filter_coefs(dev, nb_plan, sr)
                if designed is not None:
                    if designed[0] == "lp24":
                        h[f"{u}/fc/gain"] = designed[1]
                        h[f"{u}/fc/secs"] = np.stack(
                            [np.stack(sec) for sec in designed[2]])
                    else:
                        h[f"{u}/fc/coefs"] = np.stack(designed[1])
            for pname, curve in dev.automation.items():
                if dev.kind == "oscillator" and pname == "frequency":
                    continue  # folded into the host track below
                cv = np.asarray(curve, np.float32)
                if cv.shape[0] < nb_plan:  # hold the final value
                    pad = np.full(nb_plan - cv.shape[0],
                                  cv[-1] if cv.size else 0.0, np.float32)
                    cv = np.concatenate([cv, pad])
                h[f"{u}/auto/{pname}"] = cv
            if dev.kind == "oscillator":
                self._osc_tracks[u] = self._oscillator_track(dev)
                continue
            if (dev.role != "instrument" and dev.kind != "calculator") \
                    or dev.notes is None or dev.notes.count == 0:
                continue
            if dev.kind == "toy-instrument":
                continue
            if dev.kind in (*WELSH, "fm-synthesizer") and dev.voice is None:
                continue  # the loader warned; renders silent
            self._collect_notes(dev)
        # per-bucket capacity = the most notes overlapping any linear
        # segment, by interval sweep over segment indices: note i is active
        # in segment k iff on < (k+1)S and on+span > kS
        for u, ons in self._bucket_on.items():
            for j, on in enumerate(ons):
                span = self._spans[u][j]
                k_min = np.clip(on // self.S, 0, self.n_segs - 1)
                k_max = np.clip((on + span - 1) // self.S, 0,
                                self.n_segs - 1)
                diff = np.zeros(self.n_segs + 1, np.int64)
                np.add.at(diff, k_min, 1)
                np.add.at(diff, k_max + 1, -1)
                self._caps[(u, j)] = max(1, int(np.cumsum(diff).max()))

    def _collect_notes(self, dev: DeviceIR) -> None:
        """One note instrument's buckets: note columns, global note ids,
        host control constants (Welsh), host frequencies and phase tables
        (FM, envelope), slots and ratios (sample tables)."""
        c = self.c
        sr = float(c.sample_rate)
        h = self.host_inputs
        u = dev.uvid
        notes = dev.notes
        # unison triples the RENDERED notes only
        keys_a, vels_a, on_a, off_a, prev_a = \
            welsh_model.unison_input_notes(notes, dev.voice)
        gate = (off_a - on_a).astype(np.int32)
        buckets = self._note_buckets(dev, on_a, off_a)
        self._spans[u] = [s for s, _ in buckets]
        self._bucket_on[u] = []
        if dev.kind == "sampler":
            ratios = np.asarray(sampler_model.sampler_ratios(
                notes.keys, float(dev.params.get("root", 440.0))),
                np.float32)
        for j, (span, idx) in enumerate(buckets):
            b = f"{u}/b{j}"
            h[f"{b}/keys"] = keys_a[idx]
            h[f"{b}/vels"] = vels_a[idx]
            h[f"{b}/on"] = on_a[idx]
            h[f"{b}/gate"] = gate[idx]
            # global note indices: noise keying is invariant to the bucket
            # partition and the per-segment overlap set
            h[f"{b}/ids"] = idx.astype(np.int32)
            if prev_a is not None:  # glide sources
                h[f"{b}/prev"] = prev_a[idx]
            if dev.kind in WELSH:
                pv = None if prev_a is None else prev_a[idx]
                hc = welsh_model.host_osc_constants(dev.voice, keys_a[idx],
                                                    pv)
                hc.update(welsh_model.host_gate_seconds(gate[idx], sr))
                tabs = welsh_model.host_filter_tables(
                    dev.voice, gate[idx].astype(np.int64), int(span), sr)
                if tabs is not None:
                    hc.update(tabs)
                php = welsh_model.host_pitch_phases(
                    dev.voice, keys_a[idx], pv, int(span), sr)
                if php is not None:
                    hc.update(php)
                lvt = welsh_model.host_lfo_table(dev.voice, int(span), sr)
                if lvt is not None:
                    hc.update(lvt)
                for name, arr in hc.items():
                    h[f"{b}/hc/{name}"] = arr
            elif dev.kind in ("fm-synthesizer", "envelope"):
                h[f"{b}/hc/f1"] = np.asarray(
                    note_freqs(np.asarray(keys_a[idx])), np.float32)
                if dev.kind == "fm-synthesizer" \
                        and "ratio" not in dev.automation:
                    php = fm_model.host_phases(dev.voice, keys_a[idx],
                                               int(span), sr)
                    if php is not None:
                        for nm, arr in php.items():
                            h[f"{b}/hc/{nm}"] = arr
            if u in self._sliced:
                # host time-base constants the slice path gathers from
                tf, tbf = welsh_model.slice_time_bases(span, sr)
                h[f"{b}/tfull"] = tf
                h[f"{b}/tbfull"] = tbf
            if dev.sample_table is not None:
                h[f"{b}/slots"] = dev.slots[idx]
            if dev.kind == "sampler":
                h[f"{b}/ratios"] = ratios[idx]
            self._bucket_on[u].append(np.asarray(on_a[idx], np.int64))
        if dev.sample_table is not None:
            h[f"{u}/table"] = dev.sample_table.data
            h[f"{u}/lengths"] = dev.sample_table.lengths
            h[f"{u}/rates"] = dev.sample_table.rates

    def _bucket_noise_keys(self) -> dict:
        """Per-bucket noise keys of the sliced devices {(uvid, bucket):
        {which: [count, 2]}}, the fold of each note's identity into
        fold_in(PRNGKey(0), which) — drawn once here instead of every
        segment (the same bits)."""
        out = {}
        for u in self._sliced:
            v = self.c.devices[u].voice
            which = [w for w, osc in ((1, v.oscillator_1),
                                      (2, v.oscillator_2))
                     if osc.waveform.kind == "noise"]
            if v.noise > 0.0:
                which.append(3)
            for j in range(len(self._spans[u])):
                ids = self.inputs[f"{u}/b{j}/ids"]
                out[(u, j)] = {w: osc_ops.noise_keys(
                    prng.fold_in(prng.prng_key(0, self.device), w), ids)
                    for w in which}
        return out

    def _overlap(self, u: str, j: int, t0: int, seg_len: int) -> np.ndarray:
        on = self._bucket_on[u][j]
        span = self._spans[u][j]
        return np.nonzero((on < t0 + seg_len) & (on + span > t0))[0]

    def _seg_xs(self, t0: int, seg_len: int) -> dict:
        """Per-segment inputs: the playhead, the oscillator tracks' slices
        and, per bucket, the padded index list of its overlapping notes
        (on the device, and on the host as "hidx") and the mask of real
        rows."""
        xs = {"t0": int(t0)}
        for u, track in self._osc_tracks.items():
            xs[f"{u}/osc"] = torch.from_numpy(
                track[t0:t0 + seg_len]).to(self.device)
        for (u, j), cap in self._caps.items():
            idx = self._overlap(u, j, t0, seg_len)
            if idx.size > cap:
                # a loop window can overlap more notes than any linear
                # segment: widen the capacity
                self._caps[(u, j)] = cap = int(idx.size)
            mask = np.zeros(cap, np.float32)
            mask[: idx.size] = 1.0
            full = np.zeros(cap, np.int64)
            full[: idx.size] = idx
            xs[f"{u}/b{j}/hidx"] = full
            xs[f"{u}/b{j}/idx"] = torch.from_numpy(full).to(self.device)
            xs[f"{u}/b{j}/m"] = torch.from_numpy(mask).to(self.device)
        return xs

    # ---- launch plan --------------------------------------------------------

    def _filter_plan(self, dev: DeviceIR) -> dict:
        """Carried-state kernel launches of one filter device a segment."""
        u, k = dev.uvid, dev.kind
        mode = self._filter_modes.get(u)
        sidechain = any(t == u for _, t, _ in self.c.sidechain)
        sections = [None]
        if k == "filter-low-pass-24db":
            sections = [None, None]
            if not dev.automation and not sidechain and mode is None:
                sr = float(self.c.sample_rate)
                q = max(float(dev.params.get("passband-ripple", 0.707)),
                        1e-3)
                _, secs = iir.lp24_sections(
                    float(dev.params.get("cutoff", 1000.0)), q, sr)
                sections = secs
        else:
            static = self._rbj(
                k, lambda name, d: float(dev.params.get(name, d)),
                float(self.c.sample_rate))
            if static is None:
                return {}  # an unknown filter kind passes through
            if not dev.automation and not sidechain and mode is None:
                sections = [static]
        out = {"biquad_stream": 0, "biquad_serial_stream": 0}
        for sec in sections:
            if mode == "refine":
                out["biquad_stream"] += 2
            elif mode == "serial" or (
                    sec is not None and iir._near_critical_static(sec)):
                out["biquad_serial_stream"] += 1
            else:
                out["biquad_stream"] += 1
        return out

    @staticmethod
    def _rbj(kind: str, PB, sr: float):
        """A 12 dB filter's (b0, b1, b2, a1, a2) from its parameters as
        PB(name, default) gives them (numbers design on the host, tensors
        on the device), or None for an unknown kind."""
        cutoff = PB("cutoff", 1000.0)
        if kind in ("filter-low-pass-12db", "filter-high-pass-12db",
                    "filter-all-pass-12db"):
            design = {"filter-low-pass-12db": iir.rbj_low_pass,
                      "filter-high-pass-12db": iir.rbj_high_pass,
                      "filter-all-pass-12db": iir.rbj_all_pass}[kind]
            return design(cutoff, _fmax(PB("q", 0.707), 1e-3), sr)
        if kind == "filter-band-pass-12db":
            return iir.rbj_band_pass(
                cutoff, _fmax(PB("bandwidth", 1.0), 1e-3), sr)
        if kind == "filter-band-stop-12db":
            return iir.rbj_band_stop(
                cutoff, _fmax(PB("bandwidth", 1.0), 1e-3), sr)
        if kind == "filter-peaking-eq-12db":
            return iir.rbj_peaking_eq(
                cutoff, _fmax(PB("q", 1.0), 1e-3), PB("db-gain", 0.0), sr)
        if kind == "filter-low-shelf-12db":
            return iir.rbj_low_shelf(cutoff, PB("db-gain", 0.0), sr)
        if kind == "filter-high-shelf-12db":
            return iir.rbj_high_shelf(cutoff, PB("db-gain", 0.0), sr)
        return None

    def planned_launches(self) -> dict:
        """Kernel launches of one linear render, by LAUNCHES key: per
        segment, each sliced bucket one stream-kernel call (K7 or K8),
        each unsliced Welsh bucket one cascade (K2 for 'refine'/'serial'
        voices, else K3), each FM bucket under a `ratio` curve its
        modulator phase on scan1 (two calls where the span is a multiple
        of 64, every bucket's is), each smoothing compressor two S1 calls,
        each reverb six S2 calls, each filter section one S3 call (two
        when refined) or one S4 call. Kernels it never launches are
        left out."""
        out = {**dict.fromkeys(STATE_KERNEL.values(), 0),
               "lp24_refined": 0, "lp24": 0, "scan1": 0,
               "scan_stream": 0, "comb_stream": 0, "biquad_stream": 0,
               "biquad_serial_stream": 0}
        for u in self.c.order:
            dev = self.c.devices[u]
            k = dev.kind
            buckets = len(self._spans.get(u, ()))
            if u in self._sliced:
                layout = next(iter(welsh_model.slice_state_init(
                    0, self._welsh_refine.get(u))))
                out[STATE_KERNEL[layout]] += buckets
            elif k in WELSH:
                key = "lp24_refined" if self._welsh_refine.get(u) \
                    else "lp24"
                out[key] += buckets
            elif k == "fm-synthesizer" and "ratio" in dev.automation:
                out["scan1"] += sum(2 if s % fm_model.CBLOCK == 0 else 1
                                    for s in self._spans.get(u, ()))
            elif k == "compressor" and self._smoothed_compressor(dev):
                out["scan_stream"] += 2
            elif k == "reverb":
                out["comb_stream"] += len(delayfx.COMB_DELAYS_S) + len(
                    delayfx.ALLPASS_DELAYS_S)
            elif k.startswith("filter-") and dev.role != "controller":
                for key, v in self._filter_plan(dev).items():
                    out[key] += v
        return {key: v * self.n_segs for key, v in out.items() if v}

    # ---- state -------------------------------------------------------------

    def _smoothed_compressor(self, dev: DeviceIR) -> bool:
        att = float(dev.params.get("attack", 0.0))
        rel = float(dev.params.get("release", 0.0))
        if att > 0.0 or rel > 0.0:
            return True
        if "attack" in dev.automation or "release" in dev.automation:
            return True
        return any(tgt == dev.uvid and p in ("attack", "release")
                   for _, tgt, p in self.c.sidechain)

    def init_state(self) -> dict:
        """Fresh carried state: every stateful effect's and sidechain
        source's entries (the reference's keys and shapes) and, per sliced
        bucket, one cascade state slot per note plus the scratch slot
        (welsh.slice_state_init)."""
        c = self.c
        sr = float(c.sample_rate)
        st: dict[str, torch.Tensor] = {}
        sc_targets = {(t, p) for _, t, p in c.sidechain}

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32,
                               device=self.device)

        for dev in c.devices.values():
            u, k = dev.uvid, dev.kind
            if dev.role == "controller" \
                    and k != "signal-passthrough-controller":
                continue
            if k == "compressor" and self._smoothed_compressor(dev):
                st[f"{u}/catt"] = z(2)
                st[f"{u}/crel"] = z(2)
            elif k in ("delay", "chorus"):
                pname = "delay" if k == "delay" else "delay-seconds"
                if pname in dev.automation:
                    # the carried tail covers the curve's maximum
                    d = int(round(float(np.max(dev.automation[pname]))
                                  * sr))
                else:
                    d = int(round(float(dev.params.get(pname, 0.0)) * sr))
                if (u, pname) in sc_targets:
                    # a sidechain value has no host maximum: the engine's
                    # clamp bound
                    d = max(d, int(round(SIDECHAIN_SECONDS_MAX * sr)))
                if d > 0:
                    st[f"{u}/{'dl' if k == 'delay' else 'ch'}"] = z(2, d)
            elif k == "reverb":
                for i, d_s in enumerate(delayfx.COMB_DELAYS_S):
                    d = max(1, int(round(d_s * sr)))
                    st[f"{u}/comb{i}/x"] = z(2, d)
                    st[f"{u}/comb{i}/y"] = z(2, d)
                for i, d_s in enumerate(delayfx.ALLPASS_DELAYS_S):
                    st[f"{u}/ap{i}/w"] = z(2, max(1, int(round(d_s * sr))))
            elif k.startswith("filter-"):
                refined = self._filter_modes.get(u) == "refine"
                lp24 = k == "filter-low-pass-24db"
                for i in (range(2) if lp24 else [None]):
                    if refined:
                        pre = f"{u}/rf{i}" if lp24 else f"{u}/rf"
                        for name, v in sops.refined_state_init(
                                (2,), device=self.device).items():
                            st[f"{pre}/{name}"] = v
                    else:
                        pre = f"{u}/lp24/{i}" if lp24 else f"{u}/bq"
                        st[f"{pre}/s1"] = z(2)
                        st[f"{pre}/s2"] = z(2)
        for src, _, _ in c.sidechain:
            st[f"{src}/sc"] = z()
        for u in self._sliced:
            mode = self._welsh_refine.get(u)
            for j, ons in enumerate(self._bucket_on[u]):
                for k, v in welsh_model.slice_state_init(
                        len(ons), mode, self.device).items():
                    st[f"{u}/b{j}/wf/{k}"] = v
        return st

    # ---- one segment -------------------------------------------------------

    def _block_seg(self, key: str, t0: int, n: int) -> torch.Tensor:
        """The segment's entries of a block-rate input curve."""
        return self.inputs[key][t0 // BLOCK:(t0 + n) // BLOCK]

    def _param_seg(self, dev, name, default, t0, n, override=None):
        """Per-sample [n] tensor if automated or overridden, else a
        float."""
        if override is not None:
            return override
        key = f"{dev.uvid}/auto/{name}"
        if key in self.inputs:
            return iir.upsample_hold(self._block_seg(key, t0, n), n, BLOCK)
        return float(dev.params.get(name, default))

    def _hc_seg(self, b: str, idx):
        """The segment batch's host-control dict: per-note rows gathered by
        idx (padded rows read row 0 — masked at the sum), tables whole."""
        prefix = f"{b}/hc/"
        hc = {}
        for key, v in self.inputs.items():
            if key.startswith(prefix):
                name = key[len(prefix):]
                hc[name] = v[idx] if name in welsh_model.HOST_CTL_PER_NOTE \
                    else v
        return hc

    def _zeros(self, n: int) -> torch.Tensor:
        return torch.zeros((2, n), dtype=torch.float32, device=self.device)

    def _warn_once(self, dev: DeviceIR, msg: str) -> None:
        if dev.uvid not in self._warned:
            self._warned.add(dev.uvid)
            warn(msg)

    def _render_instrument_seg(self, dev: DeviceIR, xs, t0: int, n: int,
                               state: dict) -> torch.Tensor:
        """One instrument's [2, n] segment (groove_tpu/engine/stream.py
        :713-870)."""
        u = dev.uvid
        sr = float(self.c.sample_rate)
        if dev.kind == "oscillator":
            mono = xs[f"{u}/osc"]  # the host track's slice (_seg_xs)
            return torch.stack([mono, mono])
        if dev.kind == "toy-instrument":
            mono = simple_model.toy_instrument(
                float(dev.params.get("fake-value", 0.0)), n, self.device)
            return torch.stack([mono, mono])
        if u not in self._spans:
            return self._zeros(n)  # no notes, or a voice that did not load

        def P(name, default):
            return self._param_seg(dev, name, default, t0, n)

        inp = self.inputs
        out = self._zeros(n)
        for j, span in enumerate(self._spans[u]):
            b = f"{u}/b{j}"
            idx = xs[f"{b}/idx"]
            m = xs[f"{b}/m"]
            keys = inp[f"{b}/keys"][idx]
            vels = inp[f"{b}/vels"][idx] * m
            gate = inp[f"{b}/gate"][idx]
            ids = inp[f"{b}/ids"][idx]
            on_h = self._host_on[f"{b}/on"][xs[f"{b}/hidx"]]

            def place(note_audio, m=m, on_rel=on_h - t0 + span, span=span):
                # padded rows are zeroed by the mask, so their scatter adds
                # exact zeros
                mshape = (m.shape[0],) + (1,) * (note_audio.dim() - 1)
                note_audio = note_audio * m.reshape(mshape)
                placed = scatter_notes(note_audio, on_rel, n + span)
                return placed[..., span:span + n]

            if dev.kind in WELSH and u in self._sliced:
                mono = self._sliced_bucket(dev, j, xs, t0, n, state, keys,
                                           vels, gate, ids)
                out = out + torch.stack([mono, mono])  # DCA applied after
            elif dev.kind in WELSH:
                pv = inp[f"{b}/prev"][idx] if f"{b}/prev" in inp else None
                mono = place(welsh_model.render_notes(
                    dev.voice, keys, vels, gate, span, sr,
                    refine_filter=self._welsh_refine.get(u, False),
                    note_ids=ids, prev_keys=pv,
                    host_ctl=self._hc_seg(b, idx) or None))
                out = out + torch.stack([mono, mono])
            elif dev.kind == "fm-synthesizer":
                ac = {nm: inp[f"{u}/auto/{nm}"]
                      for nm in ("ratio", "depth", "beta")
                      if f"{u}/auto/{nm}" in inp}
                hcf = self._hc_seg(b, idx)
                mono = place(fm_model.render_notes(
                    dev.voice, keys, vels, gate, span, sr, on_frames=on_h,
                    ratio_b=ac.get("ratio"), depth_b=ac.get("depth"),
                    beta_b=ac.get("beta"), freqs=hcf.get("f1"),
                    phases=hcf if "phm" in hcf else None))
                out = out + torch.stack([mono, mono])
            elif dev.kind in ("drumkit", "sampler", "calculator"):
                slots = inp[f"{b}/slots"][idx]
                unity = dev.kind in ("drumkit", "calculator") and all(
                    int(r) == self.c.sample_rate
                    for r in dev.sample_table.rates)
                if unity:
                    # aligned row copy: no fractional gather
                    stereo = sampler_model.render_notes_aligned(
                        inp[f"{u}/table"], inp[f"{u}/lengths"], slots,
                        torch.full_like(gate, span), vels, span)
                else:
                    if dev.kind == "sampler":
                        gate_eff = gate
                        ratios = inp[f"{b}/ratios"][idx]
                    else:
                        gate_eff = torch.full_like(gate, span)  # one-shots
                        ratios = torch.ones(keys.shape[0],
                                            dtype=torch.float32,
                                            device=self.device)
                    stereo = sampler_model.render_notes(
                        inp[f"{u}/table"], inp[f"{u}/lengths"],
                        inp[f"{u}/rates"], slots, ratios, gate_eff, vels,
                        span, sr)
                out = out + place(stereo)
            elif dev.kind == "envelope":
                adsr = (float(dev.params.get("attack", 0.0)),
                        float(dev.params.get("decay", 0.0)),
                        float(dev.params.get("sustain", 1.0)),
                        float(dev.params.get("release", 0.0)))
                mono = place(simple_model.envelope_instrument(
                    adsr, keys, vels, gate, span, sr,
                    freqs=inp[f"{b}/hc/f1"][idx]))
                out = out + torch.stack([mono, mono])
            else:
                self._warn_once(dev, f"unknown instrument kind {dev.kind}; "
                                "silent")
        if dev.kind in WELSH:
            # the voice DCA (centre pan), then the synth DCA
            lv, rv = pan_gains(0.0, self.device)
            ls, rs = pan_gains(P("pan", 0.0), self.device)
            g = P("gain", 1.0)
            out = torch.stack([out[0] * lv * ls * g, out[1] * rv * rs * g])
        elif dev.kind == "fm-synthesizer":
            left, right = pan_gains(P("pan", dev.voice.pan), self.device)
            g = P("gain", dev.voice.gain)
            out = torch.stack([out[0] * left * g, out[1] * right * g])
        return out

    def _sliced_bucket(self, dev, j, xs, t0, n, state, keys, vels, gate,
                       ids) -> torch.Tensor:
        """A sliced bucket's mono segment: exactly this segment's slice of
        every active note, cascade state carried per note. Padded rows go
        to the bucket's scratch slot, so duplicate writes can never touch
        a real note's state; their audio is masked at the sum."""
        u = dev.uvid
        b = f"{u}/b{j}"
        idx, m = xs[f"{b}/idx"], xs[f"{b}/m"]
        inp = self.inputs
        count = len(self._bucket_on[u][j])
        slot = torch.where(m > 0, idx, count)
        age0 = t0 - inp[f"{b}/on"][idx].to(torch.int64)
        prefix = f"{b}/wf/"
        fst = {k[len(prefix):]: state[k][slot]
               for k in state if k.startswith(prefix)}
        nk = {w: keys_w[idx]
              for w, keys_w in self._noise_keys[(u, j)].items()}
        mono_rows, fst2 = welsh_model.render_notes_slice(
            dev.voice, keys, vels, gate, age0, n, float(self.c.sample_rate),
            fst, inp[f"{b}/tfull"], inp[f"{b}/tbfull"], note_ids=ids,
            fidelity=self._welsh_refine.get(u),
            host_ctl=self._hc_seg(b, idx), noise_keys=nk)
        for k, v in fst2.items():
            state[prefix + k][slot] = v
        return _row_sum(mono_rows * m[:, None])

    def _apply_effect_seg(self, dev: DeviceIR, x, t0: int, n: int,
                          overrides: dict, state: dict):
        """One effect on its segment input, advancing its carried state in
        `state` (groove_tpu/engine/stream.py:872-1132)."""
        sr = float(self.c.sample_rate)
        k = dev.kind
        u = dev.uvid

        def P(name, default):
            return self._param_seg(dev, name, default, t0, n,
                                   override=overrides.get((u, name)))

        if k == "mixer" or k == "signal-passthrough-controller":
            return x
        if k == "gain":
            return effects.gain(x, P("ceiling", 1.0))
        if k == "limiter":
            return effects.limiter(x, P("minimum", 0.0), P("maximum", 1.0))
        if k == "bitcrusher":
            bits = overrides.get((u, "bits-to-crush"))
            if bits is None:
                if f"{u}/auto/bits-to-crush" in self.inputs:
                    bits = P("bits-to-crush", 8.0)
                else:
                    bits = float(dev.params.get("bits", 8))
            return effects.bitcrusher(x, bits)
        if k == "compressor":
            thr = P("threshold", 1.0)
            ratio = P("ratio", 1.0)
            if not self._smoothed_compressor(dev):
                return dynamics.compressor(x, thr, ratio)
            # sidechain-driven seconds clamp to the engine bound
            att = overrides.get((u, "attack"))
            att = (torch.clamp(att, 0.0, SIDECHAIN_SECONDS_MAX)
                   if att is not None else P("attack", 0.0))
            rel = overrides.get((u, "release"))
            rel = (torch.clamp(rel, 0.0, SIDECHAIN_SECONDS_MAX)
                   if rel is not None else P("release", 0.0))
            y, sa, sr_ = sops.compressor_smoothed_stream(
                x, thr, ratio, att, rel, sr, state[f"{u}/catt"],
                state[f"{u}/crel"])
            state[f"{u}/catt"] = sa
            state[f"{u}/crel"] = sr_
            return y
        if k == "delay":
            return self._delay_seg(dev, x, t0, n, overrides, state)
        if k == "chorus":
            return self._chorus_seg(dev, x, t0, n, overrides, state, P)
        if k == "reverb":
            ov = overrides.get((u, "seconds"))
            key = f"{u}/auto/seconds"
            if ov is not None or key in self.inputs:
                sec_b = ov[::BLOCK] if ov is not None \
                    else self._block_seg(key, t0, n)
                y, new = sops.reverb_stream_automated(
                    x, state, P("attenuation", 1.0), sec_b, sr, u)
            else:
                y, new = sops.reverb_stream(
                    x, state, P("attenuation", 1.0),
                    float(dev.params.get("seconds", 0.0)), sr, u)
            state.update(new)
            return y
        if k == "toy":
            return simple_model.toy_effect(x)
        if k.startswith("filter-"):
            return self._filter_seg(dev, x, t0, n, overrides, state)
        self._warn_once(dev, f"unknown effect kind {k}; passthrough")
        return x

    def _delay_seg(self, dev, x, t0, n, overrides, state):
        u = dev.uvid
        if f"{u}/dl" not in state:
            return x
        sr = float(self.c.sample_rate)
        ov = overrides.get((u, "delay"))
        key = f"{u}/auto/delay"
        if ov is not None:
            # a sidechain-driven delay time: the override is this
            # segment's 64-sample hold; clamped like the whole path
            d_b = torch.clamp(ov[::BLOCK], 0.0, SIDECHAIN_SECONDS_MAX)
            y, h = sops.delay_stream_automated(x, state[f"{u}/dl"], d_b, sr)
        elif key in self.inputs:
            y, h = sops.delay_stream_automated(
                x, state[f"{u}/dl"], self._block_seg(key, t0, n), sr)
        else:
            y, h = sops.delay_stream(x, state[f"{u}/dl"])
        state[f"{u}/dl"] = h
        return y

    def _chorus_seg(self, dev, x, t0, n, overrides, state, P):
        u = dev.uvid
        if f"{u}/ch" not in state:
            return x
        sr = float(self.c.sample_rate)
        total_d = state[f"{u}/ch"].shape[-1]
        dkey, vkey = f"{u}/auto/delay-seconds", f"{u}/auto/voices"
        ov_d = overrides.get((u, "delay-seconds"))
        ov_v = overrides.get((u, "voices"))
        voices = int(dev.params.get("voices", 1))
        if ov_d is None and ov_v is None and dkey not in self.inputs \
                and vkey not in self.inputs:
            y, h = sops.chorus_stream(x, state[f"{u}/ch"], voices, total_d,
                                      P("wet-dry-mix", 1.0))
            state[f"{u}/ch"] = h
            return y
        if ov_v is not None:
            voices_b, maxv = ov_v[::BLOCK], max(1, voices)
        elif vkey in self.inputs:
            voices_b = self._block_seg(vkey, t0, n)
            maxv = delayfx.chorus_curve_max_voices(dev.automation["voices"])
        else:
            voices_b, maxv = None, None
        if ov_d is not None:
            delay_b = torch.clamp(ov_d[::BLOCK], 0.0, SIDECHAIN_SECONDS_MAX)
        elif dkey in self.inputs:
            delay_b = self._block_seg(dkey, t0, n)
        else:
            delay_b = float(dev.params.get("delay-seconds", 0.0))
        y, h = sops.chorus_stream_automated(
            x, state[f"{u}/ch"], voices, delay_b, sr, P("wet-dry-mix", 1.0),
            voices_b=voices_b, max_voices=maxv)
        state[f"{u}/ch"] = h
        return y

    def _section(self, x, sec, state, pre: str, refined: bool,
                 serial: bool, nb: int):
        """One filter section on its segment with its carried state under
        `pre`: the refined pass (coefficients held per block), else the
        two-level scheme or the serial scan."""
        if refined:
            sec = tuple(as_f32(c, x.device).expand(nb) for c in sec)
            st = {name: state[f"{pre}/{name}"] for name in REFINED_KEYS}
            y, st2 = sops.biquad_stream_refined(x, sec, st)
            for name, v in st2.items():
                state[f"{pre}/{name}"] = v
            return y
        y, (s1, s2) = sops.biquad_stream(
            x, sec, (state[f"{pre}/s1"], state[f"{pre}/s2"]), serial=serial)
        state[f"{pre}/s1"] = s1
        state[f"{pre}/s2"] = s2
        return y

    def _filter_seg(self, dev, x, t0, n, overrides, state):
        """Every filter-* effect at the 64-frame control cadence: a host
        table's blocks, a static design (numbers: SCALAR kernels, or the
        serial scan near z = 1), or a sidechain's per-block design on the
        device; block-rate coefficients stay per block."""
        k, u = dev.kind, dev.uvid
        sr = float(self.c.sample_rate)
        nb = n // BLOCK
        b0 = t0 // BLOCK
        mode = self._filter_modes.get(u)
        refined, serial = mode == "refine", mode == "serial"

        def PB(name, default):
            ov = overrides.get((u, name))
            if ov is not None:
                return ov[::BLOCK]
            key = f"{u}/auto/{name}"
            if key in self.inputs:
                return self._block_seg(key, t0, n)
            return float(dev.params.get(name, default))

        def blk(c):
            return as_f32(c, x.device).expand(nb)

        cutoff = PB("cutoff", 1000.0)
        if k == "filter-low-pass-24db":
            q = PB("passband-ripple", 0.707)
            if f"{u}/fc/secs" in self.inputs:
                # the host table's blocks: the same constants at every
                # segmentation
                fsec = self.inputs[f"{u}/fc/secs"][:, :, b0:b0 + nb]
                y = x * iir.upsample_hold(
                    self.inputs[f"{u}/fc/gain"][b0:b0 + nb], n, BLOCK)
                secs = [tuple(fsec[i, j] for j in range(5))
                        for i in range(2)]
            elif isinstance(cutoff, float) and isinstance(q, float):
                gain_s, secs = iir.lp24_sections(cutoff, max(q, 1e-3), sr)
                y = x * float(gain_s)
            else:
                gain_b, secs_b = iir.lp24_sections(
                    blk(cutoff), _fmax(q, 1e-3), sr)
                y = x * iir.upsample_hold(blk(gain_b), n, BLOCK)
                secs = [tuple(blk(c) for c in sec) for sec in secs_b]
            for i, sec in enumerate(secs):
                pre = f"{u}/rf{i}" if refined else f"{u}/lp24/{i}"
                y = self._section(y, sec, state, pre, refined, serial, nb)
            return y
        if f"{u}/fc/coefs" in self.inputs:
            co = self.inputs[f"{u}/fc/coefs"][:, b0:b0 + nb]
            coefs = tuple(co[j] for j in range(5))
        else:
            coefs = self._rbj(k, PB, sr)
            if coefs is None:
                self._warn_once(dev, f"unknown filter kind {k}; "
                                "passthrough")
                return x
        # block-rate entries stay per block; static ones stay numbers (so
        # the serial near-critical route applies)
        coefs = tuple(c if is_scalar(c) else blk(c) for c in coefs)
        pre = f"{u}/rf" if refined else f"{u}/bq"
        return self._section(x, coefs, state, pre, refined, serial, nb)

    def step(self, state: dict, xs: dict, n: int) -> torch.Tensor:
        """Render one segment [n, 2] at xs["t0"], advancing `state` (in
        place) past it."""
        c = self.c
        t0 = xs["t0"]
        outputs: dict[str, torch.Tensor] = {}
        overrides: dict[tuple, torch.Tensor] = {}
        sidechain_by_src: dict = {}
        for src, tgt, pname in c.sidechain:
            sidechain_by_src.setdefault(src, []).append((tgt, pname))
        sends_by_aux: dict = {}
        for src, aux, amount in c.sends:
            sends_by_aux.setdefault(aux, []).append((src, amount))
        for uvid in c.order:
            dev = c.devices[uvid]
            if dev.role == "instrument" or dev.kind == "calculator":
                outputs[uvid] = self._render_instrument_seg(dev, xs, t0, n,
                                                            state)
                continue
            acc = self._zeros(n)
            for s in c.sinks.get(uvid, []):
                if s in outputs:
                    acc = acc + outputs[s]
            for s, amount in sends_by_aux.get(uvid, []):
                if s in outputs:
                    acc = acc + amount * outputs[s]
            if dev.role == "controller" \
                    and dev.kind != "signal-passthrough-controller":
                continue
            outputs[uvid] = self._apply_effect_seg(dev, acc, t0, n,
                                                   overrides, state)
            if uvid in sidechain_by_src:
                # one-block-delayed |mean|; the carried scalar is the value
                # leaving the previous segment
                last = acc[:, BLOCK - 1::BLOCK]
                val = torch.abs(torch.mean(last, dim=0))
                shifted = torch.cat([state[f"{uvid}/sc"][None], val[:-1]])
                state[f"{uvid}/sc"] = val[-1]
                per_sample = iir.upsample_hold(shifted, n, BLOCK)
                for tgt, pname in sidechain_by_src[uvid]:
                    # ControlValue -> domain units, as the Renderer maps it
                    p = param_mod.resolve(c.devices[tgt].kind, pname)
                    overrides[(tgt, pname)] = (
                        param_mod.to_domain_array(p, per_sample)
                        if p is not None else per_sample)
        out = outputs.get(MAIN_MIXER_UVID, self._zeros(n))
        return out.T  # [n, 2]

    # ---- render loops ------------------------------------------------------

    def stream(self, prefetch_segments: int = 4, batch_segments: int = 1,
               quantize: bool = False, mono_fold: bool | None = None):
        """Yield host [frames, 2] arrays covering exactly n_frames, in
        order (int16 when quantize, else float32). Up to
        `prefetch_segments` fetches stay in flight behind the device.
        batch_segments > 1 renders that many segments with the same step
        and fetches them as one array (bitwise the same audio). mono_fold
        (None = auto by channel_symmetric): fetch one channel plus a
        device-computed tripwire, duplicated on the host."""
        fold = self.mono_foldable if mono_fold is None else bool(mono_fold)
        k = max(1, min(int(batch_segments), self.n_segs))
        state = self.init_state()
        pending: deque = deque()
        emitted = 0

        def fetch(audio):
            nonlocal emitted
            out = audio.cpu().numpy()
            if fold:
                out = _unfold_mono(out)
            take = min(len(out), self.c.n_frames - emitted)
            emitted += take
            return out[:take]

        for first in range(0, self.n_segs, k):
            segs = [self.step(state, self._seg_xs(s * self.S, self.S),
                              self.S)
                    for s in range(first, min(first + k, self.n_segs))]
            audio = segs[0] if len(segs) == 1 else torch.cat(segs)
            if fold:
                audio = (_fold_mono_i16 if quantize
                         else _fold_mono_f32)(audio)
            elif quantize:
                audio = quantize_16bit(audio)
            pending.append(audio)
            if len(pending) > prefetch_segments:
                yield fetch(pending.popleft())
        while pending:
            yield fetch(pending.popleft())

    def render(self, batch_segments: int = 1,
               quantize: bool = False) -> np.ndarray:
        """Streamed render concatenated on the host."""
        if self.c.n_frames == 0:
            dt = np.int16 if quantize else np.float32
            return np.zeros((0, 2), dt)
        return np.concatenate(
            list(self.stream(batch_segments=batch_segments,
                             quantize=quantize)), axis=0)

    def render_scan(self) -> np.ndarray:
        """Every segment through the same step in one call, fetched once
        (the reference's lax.scan loop; bitwise render() here)."""
        state = self.init_state()
        segs = [self.step(state, self._seg_xs(k * self.S, self.S), self.S)
                for k in range(self.n_segs)]
        return torch.cat(segs).cpu().numpy()[: self.c.n_frames]

    # ---- loop-range playback ----------------------------------------------

    def loop_frames(self, start_beats: float, end_beats: float):
        """Loop range beats -> 64-frame-quantized frame window (the
        reference seeks at tick-batch granularity)."""
        tempo = Tempo(self.c.bpm)
        sr = SampleRate(self.c.sample_rate)
        ls = _round_block(beats_to_frames(tempo, sr, Fraction(start_beats)))
        le = _round_block(beats_to_frames(tempo, sr, Fraction(end_beats)))
        le = min(le, self.plan_frames)
        if le < BLOCK:
            # an empty window would make stream_loop(iterations=None)
            # spin forever yielding nothing
            raise ValueError(
                f"loop end {end_beats} beats quantizes to an empty window "
                f"(< {BLOCK} frames)")
        ls = max(0, min(ls, le - BLOCK))
        return ls, le

    def stream_loop(self, start_beats: float, end_beats: float,
                    iterations: int | None = None):
        """Loop-range playback: [0, end), then [start, end) repeatedly,
        carried state crossing every seam (the reference's clock seek).
        iterations=None loops forever; yields host float32 [frames, 2]
        arrays."""
        if self._sliced:
            raise NotImplementedError(
                "sliced welsh is linear-stream only: a seek rewinds note "
                "ages, which the carried per-note cascade state cannot "
                "follow — use WELSH_SLICED=False for loop playback")
        ls, le = self.loop_frames(start_beats, end_beats)
        state = self.init_state()

        def play_window(lo, hi):
            t0 = lo
            while t0 < hi:
                n = min(self.S, hi - t0)  # a multiple of 64
                audio = self.step(state, self._seg_xs(t0, n), n)
                t0 += n
                yield audio.cpu().numpy()

        yield from play_window(0, le)
        it = 0
        while iterations is None or it < iterations:
            yield from play_window(ls, le)
            it += 1
