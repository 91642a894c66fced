"""groove-tpu-torch CLI: render project files to WAV on a torch device.

    python -m groove_tpu_torch.cli <project.json[5]> --wav --perf \
        [--out-dir D] [--sample-rate 44100] [--device cuda]
    python -m groove_tpu_torch.cli <project> --wav --perf --stream \
        [--sliced] [--segment-frames 4096] [--stream-batch 8]
    python -m groove_tpu_torch.cli <project> --loop START END \
        [--loop-iterations 4] [--segment-frames 4096]

The whole-timeline path of groove_tpu/cli.py: compile_song (or, for a
.mid/.midi input, compile_midi_file: channel 10 on the 707 drumkit, the
other channels on Welsh patches by GM program) -> Renderer ->
render_quantized -> 16-bit WAV, named like the input with .wav and placed
next to it (or in --out-dir): every instrument and effect kind of the
reference. --stream renders segment by segment
(engine/stream.StreamingRenderer, int16 quantized on the device) and
writes each segment into the WAV as it arrives, every instrument and
effect kind with its carried state; --sliced routes Welsh voices to
sliced rendering where it wins. --loop START END bounces a loop range
(beats): [0, END) then --loop-iterations passes of [START, END), the
effects' state carried across every seam (a sliced device refuses a
loop, as the reference's does). Assets are found through
groove_tpu_torch.project.paths.Paths ($GROOVE_ASSETS first). The
reference CLI's other flags exit with "not ported yet".
"""

from __future__ import annotations

import argparse
import re
import sys
import time
from pathlib import Path

# flags of groove_tpu/cli.py that this CLI does not run yet
NOT_PORTED = (
    ("-m", "--mp3"), ("-d", "--debug"), ("-q", "--quiet"),
    ("-v", "--version"), ("--play",), ("--multidevice",), ("--mesh",),
    ("--live",), ("--midi-out",),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="groove-tpu-torch",
        description="Render Groove project files to WAV with PyTorch/CUDA.",
    )
    p.add_argument("input", nargs="*",
                   help="project files (JSON, JSON5) or MIDI files")
    p.add_argument("-w", "--wav", action="store_true",
                   help="render as WAVE file(s) (appears next to source)")
    p.add_argument("-p", "--perf", action="store_true",
                   help="print perf information")
    p.add_argument("--sample-rate", type=int, default=44100)
    p.add_argument("--out-dir", type=str, default=None,
                   help="write WAVs here instead of next to the input")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (default: cuda)")
    p.add_argument("--stream", action="store_true",
                   help="render segment-streamed with bounded device memory; "
                        "the WAV is written as segments arrive")
    p.add_argument("--segment-frames", type=int, default=262144,
                   help="streamed segment length (a multiple of 64)")
    p.add_argument("--stream-batch", type=int, default=8,
                   help="segments rendered per host fetch in --stream "
                        "(the audio is the same for every value)")
    p.add_argument("--sliced", action="store_true",
                   help="--stream only: render each segment's slice of "
                        "every active Welsh note with carried per-note "
                        "filter state, per device where the work model "
                        "says it wins")
    p.add_argument("--loop", nargs=2, type=float, metavar=("START", "END"),
                   help="bounce a loop range (beats): renders [0, END) then "
                        "--loop-iterations passes of [START, END) with "
                        "effect state carried across every seam")
    p.add_argument("--loop-iterations", type=int, default=4)
    for flags in NOT_PORTED:
        p.add_argument(*flags, nargs="*", default=None,
                       dest="np_" + flags[-1].lstrip("-").replace("-", "_"),
                       help=argparse.SUPPRESS)
    return p


def output_path(input_filename: str, out_dir: str | None) -> Path:
    out = re.sub(r"\.(json5?|midi?|nsn)$", ".wav", input_filename)
    if out == input_filename:
        raise SystemExit(
            "would overwrite input file; couldn't generate output filename"
        )
    path = Path(out)
    if out_dir:
        path = Path(out_dir) / path.name
        path.parent.mkdir(parents=True, exist_ok=True)
    return path


def main(argv=None, perf_out: list | None = None) -> int:
    """Render each input; returns 0, or 1 if any file failed. perf_out,
    when given, receives one dict of timings per rendered file."""
    args = build_parser().parse_args(argv)
    for flags in NOT_PORTED:
        if getattr(args, "np_" + flags[-1].lstrip("-").replace("-", "_")) \
                is not None:
            raise SystemExit(f"{flags[-1]}: not ported yet, see ROADMAP.md")
    if args.device.startswith("cuda"):
        from groove_tpu_torch import require_cuda
        require_cuda()
    from groove_tpu_torch.project.paths import Paths

    paths = Paths()
    rc = 0
    for input_filename in args.input:
        try:
            perf = _process_file(input_filename, paths, args)
        except (OSError, ValueError, NotImplementedError) as e:
            # per-file isolation, like the reference CLI: a bad project
            # must not abort the batch
            print(f"error: {input_filename}: {e}", file=sys.stderr)
            rc = 1
            continue
        if perf_out is not None:
            perf_out.append(perf)
    return rc


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _process_file(input_filename: str, paths, args) -> dict:
    from groove_tpu_torch.project.schema import SongSettings
    from groove_tpu_torch.compiler.song import compile_midi_file, \
        compile_song
    from groove_tpu_torch.engine.render import Renderer
    from groove_tpu_torch.io.wav import write_wav_16bit_stereo

    t0 = time.perf_counter()
    if input_filename.endswith((".mid", ".midi")):
        compiled = compile_midi_file(Path(input_filename), paths,
                                     sample_rate=args.sample_rate)
    else:
        song = SongSettings.from_project_file(Path(input_filename))
        compiled = compile_song(song, paths, sample_rate=args.sample_rate)
    if args.loop:
        return _render_loop(compiled, input_filename, args, t0)
    if args.stream:
        return _render_streamed(compiled, input_filename, args, t0)
    renderer = Renderer(compiled, device=args.device)
    _sync(renderer.device)
    setup_s = time.perf_counter() - t0
    if args.perf:
        print(f"Orchestrator instantiation time: {setup_s:.2f}s")
    print(f"Performing to queue ({compiled.n_frames} frames) ", end="")
    render_fn = renderer.render_quantized if args.wav else renderer.render
    t1 = time.perf_counter()
    samples = render_fn()  # includes the kernel build on first use
    first_s = time.perf_counter() - t1
    render_s = first_s
    if args.perf:
        # steady state: kernels built and loaded
        t2 = time.perf_counter()
        samples = render_fn()
        render_s = time.perf_counter() - t2
    print(".")
    n = len(samples)
    audio_s = n / args.sample_rate
    perf = {"input": input_filename, "frames": n, "setup_s": setup_s,
            "first_render_s": first_s, "render_s": render_s,
            "xrt": audio_s / render_s if render_s > 0 else None}
    if args.perf:
        print(f" Orchestrator performance time: {first_s:.2f}s "
              f"(first, incl. kernel build) / {render_s * 1000:.2f}ms "
              f"(steady)")
        print(f" Sample count: {n}")
        if render_s > 0 and n:
            print(f" Samples per msec: {n / (render_s * 1000.0):.2f} "
                  f"(goal >{args.sample_rate / 1000.0:.2f})")
            print(f" usec per sample: {render_s * 1e6 / n:.4f} "
                  f"(goal <{1e6 / args.sample_rate:.2f})")
            print(f" xRT: {audio_s / render_s:.1f}x realtime")
    if args.wav:
        out = output_path(input_filename, args.out_dir)
        print(f"Rendering queue to {out}")
        write_wav_16bit_stereo(out, samples, args.sample_rate)
        perf["wav"] = str(out)
    return perf


def _streaming_class(args):
    from groove_tpu_torch.engine.stream import StreamingRenderer

    if args.sliced:
        # "auto": per-device routing by the _slice_wins work model
        return type("SlicedStreamingRenderer", (StreamingRenderer,),
                    {"WELSH_SLICED": "auto"})
    return StreamingRenderer


def _render_loop(compiled, input_filename: str, args, t0: float) -> dict:
    """--loop START END: bounce the looped performance, state carried
    across every seek seam, into a WAV written as segments arrive."""
    from groove_tpu_torch.io.wav import write_wav_16bit_stereo_stream

    start_beats, end_beats = args.loop
    r = _streaming_class(args)(compiled, args.device,
                               segment_frames=args.segment_frames)
    ls, le = r.loop_frames(start_beats, end_beats)
    chunks = r.stream_loop(start_beats, end_beats,
                           iterations=args.loop_iterations)
    out = output_path(input_filename, args.out_dir)
    t1 = time.perf_counter()
    total = write_wav_16bit_stereo_stream(out, chunks, args.sample_rate)
    render_s = time.perf_counter() - t1
    expect = le + args.loop_iterations * (le - ls)
    print(f"Looped [{start_beats:g}, {end_beats:g}) beats x"
          f"{args.loop_iterations}: {total} frames (expected {expect}) "
          f"-> {out}")
    return {"input": input_filename, "frames": total,
            "expected_frames": expect, "loop_frames": [ls, le],
            "setup_s": t1 - t0, "render_s": render_s, "wav": str(out)}


def _render_streamed(compiled, input_filename: str, args, t0: float) -> dict:
    """Segment-streamed render (--stream): segments quantized to int16 on
    the device land in the WAV as they are produced."""
    import torch

    from groove_tpu_torch.io.wav import write_wav_16bit_stereo_stream

    r = _streaming_class(args)(compiled, args.device,
                               segment_frames=args.segment_frames)
    device = torch.device(args.device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    batch = max(1, min(args.stream_batch, r.n_segs))
    if args.perf:
        print(f"Orchestrator instantiation time: {setup_s:.2f}s")
    print(f"Streaming {compiled.n_frames} frames in {r.n_segs} x {r.S}-frame "
          f"segments (batch {batch}) ", end="", flush=True)
    chunks = r.stream(batch_segments=batch, quantize=True)
    t1 = time.perf_counter()
    if args.wav:
        out = output_path(input_filename, args.out_dir)
        total = write_wav_16bit_stereo_stream(out, chunks, args.sample_rate)
    else:
        total = sum(len(c) for c in chunks)
    render_s = time.perf_counter() - t1
    print(".")
    audio_s = total / args.sample_rate
    perf = {"input": input_filename, "frames": total, "setup_s": setup_s,
            "render_s": render_s,
            "xrt": audio_s / render_s if render_s > 0 else None,
            "stream": {"segments": r.n_segs, "segment_frames": r.S,
                       "batch": batch, "sliced": sorted(r._sliced),
                       "planned_launches": r.planned_launches()}}
    if args.perf:
        print(f" Streamed render: {render_s:.2f}s for {total} frames "
              f"(incl. the WAV write) — {perf['xrt']:.1f}x realtime")
    if args.wav:
        print(f"Rendering queue to {out}")
        perf["wav"] = str(out)
    return perf


if __name__ == "__main__":
    sys.exit(main())
