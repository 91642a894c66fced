"""Segment-streamed render (port of groove_tpu/engine/stream.py, the parts
that sliced Welsh voices run).

The song renders in fixed-size segments (a multiple of 64 frames) through
one step function with explicitly carried state, so device memory is
bounded by the segment size plus the state, whatever the song's length.
Segment boundaries are invisible in the output: rendering the song as ONE
segment and as MANY segments is bit-identical (tests/test_torch_stream.py,
chip_smoke.py).

Sliced Welsh voices (WELSH_SLICED): each segment renders exactly its
slice of every active note of a Welsh device (models/welsh.
render_notes_slice), carrying each note's cascade state from segment to
segment in the stream kernels K7 and K8. Notes are grouped in span buckets
(models/voices.bucket_notes); a bucket's batch per segment is padded to
its capacity (the most notes overlapping any segment), and padded rows
read and write a scratch state slot. A bucket's notes are summed in batch
order, one row after another, so a note's contribution does not depend on
which other rows share its batch.

Ported here: Welsh voices that slice (every Welsh device must route to
slicing: WELSH_SLICED True, or "auto" where _slice_wins), and the
stateless effects (mixer, passthrough, gain, limiter, bitcrusher) with
their automation. Everything else — other instruments, an unsliced Welsh
device, stateful effects (filters, dynamics, delays), sidechain links and
loop playback — raises NotImplementedError ("not ported yet").
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from groove_tpu_torch.compiler.song import CompiledSong, DeviceIR, \
    MAIN_MIXER_UVID
from groove_tpu_torch.core.time import SAMPLE_BUFFER_SIZE
from groove_tpu_torch.engine.params import inputs_from_numpy
from groove_tpu_torch.io.wav import quantize_16bit
from groove_tpu_torch.models import welsh as welsh_model
from groove_tpu_torch.ops import effects, iir, prng
from groove_tpu_torch.ops import oscillator as osc_ops
from groove_tpu_torch.ops.dca import pan_gains

BLOCK = SAMPLE_BUFFER_SIZE  # 64
WELSH = ("welsh", "welsh-raw")
STATELESS_EFFECTS = ("mixer", "signal-passthrough-controller", "gain",
                     "limiter", "bitcrusher")
# state layout -> the stream kernel that carries it (iir_kernels.LAUNCHES)
STATE_KERNEL = {"p4": "lp24_stream", "p20": "lp24_refined_stream"}


def not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(f"{kind}: not ported yet, see ROADMAP.md")


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

    segment_frames must be a multiple of 64 and at least 64.
    """

    # SLICED welsh mode: False | True (force every sliceable device — the
    # bitwise test configuration) | "auto" (route per device by the work
    # model in _slice_wins — the CLI --sliced configuration). A Welsh
    # device that does not slice is not ported.
    WELSH_SLICED = False

    # Per-sample cost of the sliced stateful cascade RELATIVE to the
    # unsliced whole-window path, the _slice_wins work model's one
    # constant. CPU: the reference's CPU calibration. CUDA: the
    # reference's TPU calibration (groove_tpu SLICE_COST_TPU), NOT
    # measured on the card — the unsliced streamed path it would be
    # measured against is not ported yet (ROADMAP).
    SLICE_COST_CPU = 2.0
    SLICE_COST_CUDA = 6.0

    def __init__(self, compiled: CompiledSong, device,
                 segment_frames: int = 65536):
        if segment_frames % BLOCK or segment_frames < BLOCK:
            raise ValueError(f"segment_frames must be a positive multiple "
                             f"of {BLOCK}, got {segment_frames}")
        self.c = compiled
        self.device = torch.device(device)
        self.S = int(segment_frames)
        self.n_segs = max(1, -(-compiled.n_frames // self.S))
        self.plan_frames = self.n_segs * self.S
        self.host_inputs: dict[str, np.ndarray] = {}
        self._spans: dict[str, list[int]] = {}
        self._bucket_on: dict[str, list[np.ndarray]] = {}
        self._caps: dict[tuple[str, int], int] = {}
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
        self._check_ported()
        self.mono_foldable = channel_symmetric(compiled)
        self._collect_inputs()
        self.inputs = inputs_from_numpy(self.host_inputs, self.device)
        self._noise_keys = self._bucket_noise_keys()

    # ---- what this port renders ------------------------------------------

    def _check_ported(self) -> None:
        if self.c.sidechain:
            raise not_ported("sidechain link in a streamed render")
        for dev in self.c.devices.values():
            if dev.role == "instrument" or dev.kind == "calculator":
                if dev.kind not in WELSH:
                    raise not_ported(f"{dev.kind} in a streamed render")
                if dev.voice is not None and dev.notes is not None \
                        and dev.notes.count and dev.uvid not in self._sliced:
                    raise not_ported("unsliced streamed Welsh voice "
                                     f"({dev.uvid})")
            elif dev.role == "effect" or \
                    dev.kind == "signal-passthrough-controller":
                if dev.kind not in STATELESS_EFFECTS:
                    raise not_ported(f"{dev.kind} in a streamed render")

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
        if dev.kind in WELSH and dev.voice is not None:
            return welsh_model.tail_seconds(dev.voice)
        return 0.0

    def _note_buckets(self, dev: DeviceIR, on, off) -> list:
        """Span buckets [(span, note_indices)] for one instrument's notes
        on/off (unison-tripled for welsh), spans cropped to the
        timeline."""
        from groove_tpu_torch.models.voices import bucket_notes

        sr = self.c.sample_rate
        gate = (off - on).astype(np.int64)
        tail = self._note_tail(dev)
        need = gate + int(np.ceil(tail * sr)) + 1
        return bucket_notes(need, self.c.n_frames)

    def _collect_inputs(self) -> None:
        c = self.c
        sr = float(c.sample_rate)
        nb_plan = self.plan_frames // BLOCK
        h = self.host_inputs
        for dev in c.devices.values():
            u = dev.uvid
            for pname, curve in dev.automation.items():
                cv = np.asarray(curve, np.float32)
                if cv.shape[0] < nb_plan:  # hold the final value
                    pad = np.full(nb_plan - cv.shape[0],
                                  cv[-1] if cv.size else 0.0, np.float32)
                    cv = np.concatenate([cv, pad])
                h[f"{u}/auto/{pname}"] = cv
            if u not in self._sliced:
                continue
            keys_a, vels_a, on_a, off_a, prev_a = \
                welsh_model.unison_input_notes(dev.notes, dev.voice)
            gate = (off_a - on_a).astype(np.int32)
            buckets = self._note_buckets(dev, on_a, off_a)
            self._spans[u] = [s for s, _ in buckets]
            self._bucket_on[u] = []
            for j, (span, idx) in enumerate(buckets):
                b = f"{u}/b{j}"
                h[f"{b}/keys"] = np.asarray(keys_a[idx], np.float32)
                h[f"{b}/vels"] = np.asarray(vels_a[idx], np.float32)
                h[f"{b}/on"] = np.asarray(on_a[idx], np.int64)
                h[f"{b}/gate"] = gate[idx]
                # global note indices: the noise keying is invariant to
                # the bucket partition and the per-segment overlap set
                h[f"{b}/ids"] = idx.astype(np.int64)
                hc = welsh_model.host_osc_constants(
                    dev.voice, keys_a[idx],
                    None if prev_a is None else prev_a[idx])
                hc.update(welsh_model.host_gate_seconds(gate[idx], sr))
                tabs = welsh_model.host_filter_tables(
                    dev.voice, gate[idx].astype(np.int64), int(span), sr)
                if tabs is not None:
                    hc.update(tabs)
                lvt = welsh_model.host_lfo_table(dev.voice, int(span), sr)
                if lvt is not None:
                    hc.update(lvt)
                for name, arr in hc.items():
                    h[f"{b}/hc/{name}"] = arr
                # host time-base constants the slice path gathers from
                tf, tbf = welsh_model.slice_time_bases(span, sr)
                h[f"{b}/tfull"] = tf
                h[f"{b}/tbfull"] = tbf
                self._bucket_on[u].append(np.asarray(on_a[idx], np.int64))
        # per-bucket capacity = max notes overlapping any segment, by
        # interval sweep over segment indices: note i is active in segment
        # k iff on < (k+1)S and on+span > kS
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

    def _bucket_noise_keys(self) -> dict:
        """Per-bucket noise keys {(uvid, bucket): {which: [count, 2]}}, the
        fold of each note's identity into fold_in(PRNGKey(0), which) —
        drawn once here instead of every segment (the same bits)."""
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
        """Per-segment inputs: the playhead and, per bucket, the padded
        index list of its overlapping notes and the mask of real rows."""
        xs = {"t0": int(t0)}
        for (u, j), cap in self._caps.items():
            idx = self._overlap(u, j, t0, seg_len)
            mask = np.zeros(cap, np.float32)
            mask[: idx.size] = 1.0
            full = np.zeros(cap, np.int64)
            full[: idx.size] = idx
            xs[f"{u}/b{j}/idx"] = torch.from_numpy(full).to(self.device)
            xs[f"{u}/b{j}/m"] = torch.from_numpy(mask).to(self.device)
        return xs

    def planned_launches(self) -> dict:
        """Stream-kernel launches of one render: one per segment for each
        bucket of each sliced device, K7 or K8 by the device's routing."""
        out = dict.fromkeys(STATE_KERNEL.values(), 0)
        for u in self._sliced:
            layout = next(iter(welsh_model.slice_state_init(
                0, self._welsh_refine.get(u))))
            out[STATE_KERNEL[layout]] += self.n_segs * len(self._spans[u])
        return out

    # ---- state -------------------------------------------------------------

    def init_state(self) -> dict:
        """Fresh carried state: per sliced bucket, one cascade state slot
        per note plus the scratch slot (welsh.slice_state_init)."""
        st: dict[str, torch.Tensor] = {}
        for u in self._sliced:
            mode = self._welsh_refine.get(u)
            for j, ons in enumerate(self._bucket_on[u]):
                for k, v in welsh_model.slice_state_init(
                        len(ons), mode, self.device).items():
                    st[f"{u}/b{j}/wf/{k}"] = v
        return st

    # ---- one segment -------------------------------------------------------

    def _param_seg(self, dev, name, default, t0, n):
        key = f"{dev.uvid}/auto/{name}"
        if key in self.inputs:
            blk = self.inputs[key][t0 // BLOCK:(t0 + n) // BLOCK]
            return iir.upsample_hold(blk, n, BLOCK)
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

    def _render_instrument_seg(self, dev: DeviceIR, xs, t0: int, n: int,
                               state: dict) -> torch.Tensor:
        u = dev.uvid
        if u not in self._sliced:
            return self._zeros(n)  # a Welsh device with no notes or voice
        sr = float(self.c.sample_rate)
        inp = self.inputs
        out = self._zeros(n)
        for j in range(len(self._spans[u])):
            b = f"{u}/b{j}"
            idx = xs[f"{b}/idx"]
            m = xs[f"{b}/m"]
            keys = inp[f"{b}/keys"][idx]
            vels = inp[f"{b}/vels"][idx] * m
            on = inp[f"{b}/on"][idx]
            gate = inp[f"{b}/gate"][idx]
            ids = inp[f"{b}/ids"][idx]
            # padded rows go to the bucket's scratch slot, so duplicate
            # writes can never touch a real note's state
            count = len(self._bucket_on[u][j])
            slot = torch.where(m > 0, idx, count)
            age0 = t0 - on
            prefix = f"{b}/wf/"
            fst = {k[len(prefix):]: state[k][slot]
                   for k in state if k.startswith(prefix)}
            nk = {w: keys_w[idx]
                  for w, keys_w in self._noise_keys[(u, j)].items()}
            mono_rows, fst2 = welsh_model.render_notes_slice(
                dev.voice, keys, vels, gate, age0, n, sr, fst,
                inp[f"{b}/tfull"], inp[f"{b}/tbfull"], note_ids=ids,
                fidelity=self._welsh_refine.get(u),
                host_ctl=self._hc_seg(b, idx), noise_keys=nk)
            for k, v in fst2.items():
                state[prefix + k][slot] = v
            mono = _row_sum(mono_rows * m[:, None])
            out = out + torch.stack([mono, mono])
        # the Welsh DCA: the voice's centre pan, then the device's pan/gain
        lv, rv = pan_gains(0.0, self.device)
        ls, rs = pan_gains(self._param_seg(dev, "pan", 0.0, t0, n),
                           self.device)
        g = self._param_seg(dev, "gain", 1.0, t0, n)
        return torch.stack([out[0] * lv * ls * g, out[1] * rv * rs * g])

    def _apply_effect_seg(self, dev: DeviceIR, x, t0: int, n: int):
        k = dev.kind

        def P(name, default):
            return self._param_seg(dev, name, default, t0, n)

        if k == "mixer" or k == "signal-passthrough-controller":
            return x
        if k == "gain":
            return effects.gain(x, P("ceiling", 1.0))
        if k == "limiter":
            return effects.limiter(x, P("minimum", 0.0), P("maximum", 1.0))
        if k == "bitcrusher":
            if f"{dev.uvid}/auto/bits-to-crush" in self.inputs:
                bits = P("bits-to-crush", 8.0)
            else:
                bits = float(dev.params.get("bits", 8))
            return effects.bitcrusher(x, bits)
        raise not_ported(f"{k} in a streamed render")

    def step(self, state: dict, xs: dict, n: int) -> torch.Tensor:
        """Render one segment [n, 2] at xs["t0"], advancing `state` (in
        place) past it."""
        c = self.c
        t0 = xs["t0"]
        outputs: dict[str, torch.Tensor] = {}
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
            outputs[uvid] = self._apply_effect_seg(dev, acc, t0, n)
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

    def stream_loop(self, start_beats: float, end_beats: float,
                    iterations: int | None = None):
        """Loop-range playback is not ported (and the reference refuses it
        for sliced Welsh voices, whose carried note state cannot follow a
        seek)."""
        raise not_ported("loop playback of a streamed render")
