"""groove-tpu-torch CLI: render project files to WAV on a torch device.

    python -m groove_tpu_torch.cli <project.json[5]> --wav --perf \
        [--out-dir D] [--sample-rate 44100] [--device cuda]
    python -m groove_tpu_torch.cli <project> --wav --perf --stream \
        [--sliced] [--segment-frames 4096] [--stream-batch 8]
    python -m groove_tpu_torch.cli <project> --loop START END \
        [--loop-iterations 4] [--segment-frames 4096]
    python -m groove_tpu_torch.cli <project> --live MIDI_PORT \
        [--midi-out MIDI_PORT] [--live-seconds S] [--wav]
    python -m groove_tpu_torch.cli <project> --wav --play
    python -m groove_tpu_torch.cli <project> --wav --debug [--quiet] [--mp3]
    python -m groove_tpu_torch.cli <project> --wav (--multidevice | --mesh)
    python -m groove_tpu_torch.cli <project> --wav --trace-dir DIR
    python -m groove_tpu_torch.cli --version

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
loop, as the reference's does). --live PORT plays the project live:
raw MIDI bytes from the port (a FIFO, file or pipe) play its instruments
through its effect chains (engine/livesong.py) into the native audio
service until Ctrl-C; --midi-out PORT echoes the incoming MIDI to an out
port; --live-seconds S stops after S seconds, and --wav writes the live
audio to a WAV instead (paced at realtime). --play streams a finished
render through the native audio service in real time. -d/--debug prints
each device's own render time (utils/profiling.profile_render), -q/--quiet
leaves out the status lines, -m/--mp3 says that MP3 output is not
implemented (as the reference does) and renders on, -v/--version prints
the version; an input of "-" is skipped, as the reference skips it.
--trace-dir DIR runs each file's processing (compile included) under
torch.profiler (utils/profiling.trace), writes its Chrome trace into DIR
with a range for each of the program's spans (compile, render, stream,
block, their layers and the kernels), on the card's timeline too, and
prints the host milliseconds and host syncs of the spans by name.
--multidevice renders the song's independent components concurrently,
one Renderer each, round-robin over the devices
(parallel/multidevice.py); --mesh shards its timeline, one shard a
device, relaxing the carried states across the seams
(parallel/meshrender.py). Their devices: every visible CUDA device for
--device cuda, else the one --device names. Assets are found through
groove_tpu_torch.project.paths.Paths ($GROOVE_ASSETS first).
"""

from __future__ import annotations

import argparse
import re
import sys
import time
from pathlib import Path

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="groove-tpu-torch",
        description="Render Groove project files to WAV with PyTorch/CUDA.",
    )
    p.add_argument("input", nargs="*",
                   help="project files (JSON, JSON5) or MIDI files")
    p.add_argument("-w", "--wav", action="store_true",
                   help="render as WAVE file(s) (appears next to source)")
    p.add_argument("-m", "--mp3", action="store_true",
                   help="render as MP3 (not yet implemented)")
    p.add_argument("-d", "--debug", action="store_true",
                   help="print each device's own render time")
    p.add_argument("-p", "--perf", action="store_true",
                   help="print perf information")
    p.add_argument("--trace-dir", metavar="DIR", default=None,
                   help="trace each file's processing with torch.profiler "
                        "into a Chrome trace in DIR, the program's spans "
                        "included, and print host ms and host syncs by "
                        "span")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress status updates")
    p.add_argument("-v", "--version", action="store_true",
                   help="print version and exit")
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
    p.add_argument("--play", action="store_true",
                   help="stream the render through the native audio service "
                        "in real time (null sink when no audio hardware)")
    p.add_argument("--live", metavar="MIDI_PORT", default=None,
                   help="play the project live: read raw MIDI bytes from "
                        "this FIFO/file port and route them through the "
                        "song's instruments and effect chains to the audio "
                        "service")
    p.add_argument("--midi-out", metavar="MIDI_PORT", default=None,
                   help="with --live: echo incoming MIDI to this out port")
    p.add_argument("--live-seconds", type=float, default=None,
                   help="with --live: stop after this many seconds (default: "
                        "play until Ctrl-C)")
    p.add_argument("--multidevice", action="store_true",
                   help="render the song's independent components "
                        "concurrently across the devices "
                        "(parallel/multidevice.py)")
    p.add_argument("--mesh", action="store_true",
                   help="shard the song's timeline across the devices with "
                        "state relaxation across the seams "
                        "(parallel/meshrender.py)")
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
    if args.version:
        from groove_tpu_torch import __version__
        print(f"groove-tpu-torch {__version__}")
        return 0
    if args.device.startswith("cuda"):
        from groove_tpu_torch import require_cuda
        require_cuda()
    from groove_tpu_torch.project.paths import Paths
    from groove_tpu_torch.utils import profiling

    if args.mp3:
        print("MP3 output is not yet implemented", file=sys.stderr)
    paths = Paths()
    rc = 0
    for input_filename in args.input:
        if input_filename == "-":
            continue
        try:
            with profiling.trace(args.trace_dir):
                perf = _process_file(input_filename, paths, args)
        except (OSError, ValueError, NotImplementedError) as e:
            # per-file isolation, like the reference CLI: a bad project
            # must not abort the batch
            print(f"error: {input_filename}: {e}", file=sys.stderr)
            rc = 1
            continue
        if args.trace_dir:
            _print_spans(args.trace_dir)
        if perf_out is not None:
            perf_out.append(perf)
    return rc


def _print_spans(trace_dir: str) -> None:
    """The traced file's spans by name: count, host ms, self ms (less
    the children's) and host syncs."""
    from groove_tpu_torch.utils import profiling

    print(f"Trace: {trace_dir}")
    print(f"  {'span':<12} {'count':>7} {'host ms':>11} {'self ms':>11} "
          f"{'host syncs':>10}")
    for name, n, total, own, syncs in profiling.summary():
        print(f"  {name:<12} {n:>7} {total:>11.3f} {own:>11.3f} "
              f"{syncs:>10}")


def _process_file(input_filename: str, paths, args) -> dict:
    from groove_tpu_torch.project.schema import SongSettings
    from groove_tpu_torch.compiler.song import compile_midi_file, \
        compile_song
    from groove_tpu_torch.engine.render import Renderer
    from groove_tpu_torch.io.wav import write_wav_16bit_stereo
    from groove_tpu_torch.utils.profiling import sync

    t0 = time.perf_counter()
    if input_filename.endswith((".mid", ".midi")):
        compiled = compile_midi_file(Path(input_filename), paths,
                                     sample_rate=args.sample_rate)
    else:
        song = SongSettings.from_project_file(Path(input_filename))
        compiled = compile_song(song, paths, sample_rate=args.sample_rate)
    if args.live:
        return _play_live(compiled, input_filename, args)
    if args.loop:
        return _render_loop(compiled, input_filename, args, t0)
    if args.stream:
        return _render_streamed(compiled, input_filename, args, t0)
    say = _status(args)
    devices = _devices(args)
    if args.multidevice:
        from groove_tpu_torch.parallel.multidevice import \
            MultiDeviceRenderer
        renderer = MultiDeviceRenderer(compiled, devices)
        say(f"Multi-device: {len(renderer.assignments)} components "
            f"across {len(devices)} device(s)")
    elif args.mesh:
        from groove_tpu_torch.parallel.meshrender import MeshRenderer
        renderer = MeshRenderer(compiled, devices)
        say(f"Mesh: timeline sharded {renderer.n_devices} ways x "
            f"{renderer.S} frames, {renderer.iterations} relaxation "
            f"round(s)")
    else:
        renderer = Renderer(compiled, device=args.device)
    for dev in devices:
        sync(dev)
    setup_s = time.perf_counter() - t0
    if args.perf:
        print(f"Orchestrator instantiation time: {setup_s:.2f}s")
    if args.debug and not (args.multidevice or args.mesh):
        # each device's own render time, like the reference's dipstick
        # metrics; the multi-device renderers are sets of renders, not
        # one profileable graph
        from groove_tpu_torch.utils.profiling import profile_render
        for name, seconds in profile_render(renderer):
            print(f"  {name}: {seconds * 1000:.2f} ms")
    say(f"Performing to queue ({compiled.n_frames} frames) ", end="")
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
    say(".")
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
        say(f"Rendering queue to {out}")
        write_wav_16bit_stereo(out, samples, args.sample_rate)
        perf["wav"] = str(out)
    if args.play:
        perf["underruns"] = _stream_realtime(samples, args.sample_rate,
                                             args.quiet)
    return perf


def _devices(args) -> list:
    """The devices a render runs on: for --multidevice and --mesh with
    --device cuda every visible CUDA device, else the one device --device
    names."""
    import torch

    if args.device == "cuda" and (args.multidevice or args.mesh):
        from groove_tpu_torch.parallel import resolve_devices
        return resolve_devices()
    return [torch.device(args.device)]


def _status(args):
    """print, or nothing under --quiet (the status lines; --perf and
    --debug output is asked for and stays)."""
    if args.quiet:
        return lambda *a, **k: None
    return print


def _stream_realtime(samples, sample_rate: int,
                     quiet: bool = False) -> int | None:
    """Push a finished render through the native ring-buffer service at
    realtime pace (the reference's audio pull model); returns its
    underruns, or None without the native library."""
    import numpy as np

    from groove_tpu_torch.io import native

    if not native.available():
        print("native audio service unavailable; skipping --play",
              file=sys.stderr)
        return None
    svc = native.AudioService(sample_rate=sample_rate, buffer_frames=64)
    try:
        pos, n = 0, len(samples)
        while pos < n:
            need = svc.needs_frames()
            if need > 0:
                chunk = samples[pos:pos + need]
                if chunk.dtype == np.int16:  # render_quantized's samples
                    chunk = chunk.astype(np.float32) / np.float32(32768.0)
                svc.write(chunk)
                pos += len(chunk)
            else:
                time.sleep(0.001)
        while svc.frames_consumed() < n:  # drain
            time.sleep(0.005)
        underruns = svc.underruns()
        if not quiet:
            print(f"Played {n / sample_rate:.2f}s ({underruns} underruns)")
        return underruns
    finally:
        svc.stop()


def _play_live(compiled, input_filename: str, args) -> dict:
    """--live PORT: MIDI bytes from the port play the project's
    instruments through its effect chains, on --device, into the native
    audio service (or with --wav into a WAV, paced at realtime) until
    Ctrl-C or --live-seconds."""
    import numpy as np

    from groove_tpu_torch.engine.livesong import (LiveSongRenderer,
                                                   LiveSongService)

    echo = None
    if args.midi_out:
        from groove_tpu_torch.io.midi_output import open_port
        echo = open_port(args.midi_out)
    renderer = LiveSongRenderer(compiled, device=args.device)
    blocks: list = []
    sink = blocks.append if args.wav else None
    # print before the open: a FIFO with no writer blocks open(2)
    _status(args)(f"Live: MIDI from {args.live}; Ctrl-C to stop", flush=True)
    src = open(args.live, "rb", buffering=0)
    svc = LiveSongService(renderer, midi_source=src, sink=sink,
                          midi_echo=echo)
    sr = compiled.sample_rate
    t0 = time.perf_counter()
    try:
        while args.live_seconds is None \
                or time.perf_counter() - t0 < args.live_seconds:
            if sink is None:
                time.sleep(0.05)
                continue
            # a sink takes blocks at the audio clock's pace
            due = t0 + svc.blocks_rendered * renderer.block_frames / sr
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            svc.pump(1)
    except KeyboardInterrupt:
        pass
    finally:
        svc.stop()
        try:
            src.close()
        except Exception:
            pass
        if echo is not None:
            echo.close()
    perf = {"input": input_filename, "live": args.live,
            "blocks": svc.blocks_rendered,
            "underruns": svc.underruns()}
    if args.wav:
        from groove_tpu_torch.io.wav import write_wav_16bit_stereo

        out = output_path(input_filename, args.out_dir)
        audio = np.concatenate(blocks) if blocks \
            else np.zeros((0, 2), np.float32)
        write_wav_16bit_stereo(out, audio, sr)
        _status(args)(f"Live audio: {len(audio)} frames to {out}")
        perf["wav"] = str(out)
        perf["frames"] = len(audio)
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
    _status(args)(f"Looped [{start_beats:g}, {end_beats:g}) beats x"
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
    from groove_tpu_torch.utils.profiling import sync

    r = _streaming_class(args)(compiled, args.device,
                               segment_frames=args.segment_frames)
    sync(torch.device(args.device))
    setup_s = time.perf_counter() - t0
    batch = max(1, min(args.stream_batch, r.n_segs))
    if args.perf:
        print(f"Orchestrator instantiation time: {setup_s:.2f}s")
    say = _status(args)
    say(f"Streaming {compiled.n_frames} frames in {r.n_segs} x {r.S}-frame "
        f"segments (batch {batch}) ", end="", flush=True)
    chunks = r.stream(batch_segments=batch, quantize=True)
    t1 = time.perf_counter()
    if args.wav:
        out = output_path(input_filename, args.out_dir)
        total = write_wav_16bit_stereo_stream(out, chunks, args.sample_rate)
    else:
        total = sum(len(c) for c in chunks)
    render_s = time.perf_counter() - t1
    say(".")
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
        say(f"Rendering queue to {out}")
        perf["wav"] = str(out)
    return perf


if __name__ == "__main__":
    sys.exit(main())
