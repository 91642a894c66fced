"""groove-shell: interactive engine front end.

The reference ships an egui GUI app (src/bin/groove-egui.rs) whose panels
drive the orchestrator service with commands (open/play/stop/tempo/save —
src/panels/orchestrator_panel.rs:21-56) and show engine events as toasts.
This is the terminal equivalent over the same service layer
(engine/service.py): a line-oriented shell, scriptable via stdin.

    $ python -m groove_tpu_torch.shell [project] [--device cuda]
    groove> open projects/scale-c4-major.json
    groove> tempo 90
    groove> play
    groove> render out.wav
    groove> save mysong.json
    groove> quit

(The port of groove_tpu/shell.py: HELP is a copy, held so by
tests/test_torch_hostcopy.py; main takes --device, the torch device the
service and a `live` synth render on, "cuda" unless asked for another,
and has no compile cache to point anywhere: kernels/build.py caches the
kernels' build.)
"""

from __future__ import annotations

import shlex
import sys

from groove_tpu_torch.engine.service import EngineService

HELP = """commands:
  open <project.json[5]|.mid>  load a project
  play                         render + stream through the audio service
  stop                         stop playback
  tempo <bpm>                  change tempo (recompiles)
  render <out.wav>             render to WAV
  save <project.json>          save the project file
  new                          new blank project
  tracks                       list tracks
  track-new [id] [channel]     add a MIDI track
  track-del <id>               delete a track
  track-dup <id>               duplicate a track
  add <kind> [channel]         add an entity (palette kind) to a channel
  remove <uvid>                remove an entity
  palette                      list addable entity kinds
  live <patch> [midi-port]     live MIDI synth (FIFO/file byte port)
  loop <start> <end> | loop off  set/clear the loop range (beats)
  bounce-loop <out.wav> [n]    render n looped passes to WAV
  status                       show title/tempo/playing/loop
  help                         this text
  quit                         exit
"""


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="groove_tpu_torch.shell")
    ap.add_argument("project", nargs="?", help="project file to open")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    opts = ap.parse_args(argv)
    events = []

    def on_event(kind, data):
        events.append((kind, data))
        print(f"[{kind}] {data if data is not None else ''}".rstrip())

    svc = EngineService(on_event=on_event, device=opts.device)
    live_services = []
    try:
        if opts.project:
            svc.open_project(opts.project)
        interactive = sys.stdin.isatty()
        while True:
            if interactive:
                print("groove> ", end="", flush=True)
            line = sys.stdin.readline()
            if not line:
                break
            parts = shlex.split(line.strip())
            if not parts:
                continue
            cmd, *args = parts
            if cmd in ("quit", "exit"):
                break
            elif cmd == "open" and args:
                svc.open_project(args[0])
            elif cmd == "play":
                svc.play()
            elif cmd == "stop":
                svc.stop()
                for lv in live_services:
                    lv.stop()
                live_services.clear()
            elif cmd == "tempo" and args:
                svc.set_tempo(float(args[0]))
            elif cmd == "render" and args:
                svc.render_wav(args[0])
            elif cmd == "save" and args:
                svc.save(args[0])
            elif cmd == "new":
                svc.new_project()
            elif cmd == "tracks":
                svc.sync()
                for t in (svc.song.tracks if svc.song else []):
                    print(f"{t.id}  ch{t.midi_channel}  "
                          f"patterns={t.pattern_ids}")
            elif cmd == "track-new":
                svc.add_track(args[0] if args else None,
                              int(args[1]) if len(args) > 1 else None)
            elif cmd == "track-del" and args:
                svc.remove_track(args[0])
            elif cmd == "track-dup" and args:
                svc.duplicate_track(args[0])
            elif cmd == "add" and args:
                svc.add_device(args[0],
                               midi_channel=int(args[1]) if len(args) > 1
                               else 0)
            elif cmd == "remove" and args:
                svc.remove_device(args[0])
            elif cmd == "palette":
                from groove_tpu_torch.engine import factory
                print(" ".join(factory.sorted_keys()))
            elif cmd == "live" and args:
                from groove_tpu_torch.engine.live import LiveMidiService, LiveSynth
                src = open(args[1], "rb", buffering=0) if len(args) > 1 else None
                synth = LiveSynth(patch=args[0], device=svc.device)
                live = LiveMidiService(synth, midi_source=src)
                print(f"live: patch={args[0]} "
                      f"port={args[1] if len(args) > 1 else '(none)'} — "
                      f"'stop' to end")
                live_services.append(live)
            elif cmd == "loop":
                # loop <start-beats> <end-beats> | loop off
                # (the control bar's Loop checkbox + range fields,
                # src/panels/control_panel.rs:143-170)
                if args and args[0] == "off":
                    svc.clear_loop()
                elif len(args) >= 2:
                    svc.set_loop(float(args[0]), float(args[1]))
                else:
                    print("usage: loop <start-beats> <end-beats> | loop off")
            elif cmd == "bounce-loop" and args:
                svc.render_loop_wav(
                    args[0], iterations=int(args[1]) if len(args) > 1 else 4)
            elif cmd == "status":
                svc.sync()  # drain queued edits so the snapshot is current
                title = svc.song.title if svc.song else None
                bpm = svc.song.clock.bpm if svc.song else None
                print(f"title={title!r} bpm={bpm} "
                      f"playing={svc.is_playing()} "
                      f"loop={svc.loop_range if svc.is_loop_enabled else None}")
            elif cmd == "help":
                print(HELP)
            else:
                print(f"unknown command {cmd!r}; try 'help'")
    finally:
        svc.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
