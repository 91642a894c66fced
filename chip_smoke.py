"""On-card smoke run of groove_tpu_torch: the offline render's first slice
(drumkit -> automated 24 dB low-pass -> mix -> 16-bit WAV) on one CUDA
device, through the hand-written kernels K1 (drums), K2 (refined lp24)
and K3 (single-pass lp24).

    python3 chip_smoke.py

Phases, one JSON line each:
  1. environment: versions, device, nvidia-smi name and power limit;
  2. build: nvcc of groove_tpu_torch/csrc into build/groove_tpu_torch;
  3. kernels against their plain torch twins on the card, at the main
     path's shapes ([2, n] for 10 s of the north-star analogue; [64, 65536]
     for K2/K3): max difference (they must agree bit for bit, as the tests
     require) and median CUDA-event times of kernel and twin;
  4. the slice through the CLI (groove_tpu_torch.cli.main --wav --perf) on
     the 3-minute north-star analogue (K1 + K2), then on the same song with
     the cutoff kept above 2 kHz (K1 + K3): render time, x realtime, peak
     device memory, WAV size and peak, kernel launch counts; each WAV is
     checked against the CPU render of the same song (the twins) bit for
     bit.
Then the kernel summary line, the nvidia-smi line, and the result line.
Without a CUDA device it exits non-zero before printing any result.
Synthetic assets and outputs go to build/chip_smoke/ in this checkout.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SONG_MEASURES = 90   # 3 minutes at 120 bpm
SONG_BPM = 120.0
CHECK_MEASURES = 5   # 10 s: the kernel-vs-twin shapes


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok: bool, what: str) -> None:
    """Fail the run (non-zero exit, no result line) unless `ok`."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps: int) -> tuple[float, object]:
    """Median CUDA-event milliseconds of `reps` calls (after one warm-up)
    and the last result."""
    import torch

    out = fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


def compare(name, kernel_fn, plain_fn, peak_ref, reps=(20, 3)):
    """Time kernel and twin on the same card inputs; they must be equal."""
    import torch

    ms, y = cuda_ms(kernel_fn, reps[0])
    plain_ms, y_plain = cuda_ms(plain_fn, reps[1])
    err = float((y - y_plain).abs().max())
    peak = max(1.0, float(peak_ref))
    db = 20.0 * (torch.log10(torch.tensor(err / peak + 1e-30)).item())
    return {"name": name, "shape": list(y.shape), "max_abs_err": err,
            "err_dbfs": db, "bitwise": bool(torch.equal(y, y_plain)),
            "ms": ms, "plain_ms": plain_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from groove_tpu.io.wav import read_wav
    from groove_tpu.project.paths import Paths
    from groove_tpu.project.schema import SongSettings
    from groove_tpu_torch import cli
    from groove_tpu_torch.compiler.song import compile_song
    from groove_tpu_torch.engine.render import Renderer
    from groove_tpu_torch.kernels import build
    from groove_tpu_torch.ops import drums, iir_kernels
    from groove_tpu_torch.ops import iir as tiir
    from groove_tpu_torch.testing import synth

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit("environment", python=sys.version.split()[0],
         torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)

    info = build.build()
    build.library()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln]
    emit("build", seconds=info["seconds"], library=info["path"],
         ptxas=ptxas)

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    assets = synth.write_assets(work / "assets")
    paths = Paths(roots=[assets])

    # ---- 3. kernels vs twins at the main path's shapes --------------------
    def kernel_inputs(measures: int, project=synth.north_star_project):
        """The drum hits and the filter's input and sections, as the
        Renderer hands them to the kernels for this song."""
        song = SongSettings.from_json(project(measures, SONG_BPM))
        r = Renderer(compile_song(song, paths), device=dev)
        n = r.c.n_frames
        hits = [r.inputs[f"drums/{k}"] for k in (
            "ptable", "hcounts", "hslots", "hstarts", "hshifts", "hlimits",
            "hvels")]
        bus = drums.accumulate_hits(*hits, n_frames=n)
        x = bus * tiir.upsample_hold(r.inputs["low-pass-1/fc/gain"], n)
        fs = r.inputs["low-pass-1/fc/secs"]
        secs = [tuple(fs[i, j].expand(2, -1) for j in range(5))
                for i in range(2)]
        return n, hits, x, secs

    n, hits, x, secs = kernel_inputs(CHECK_MEASURES)
    results = [compare(
        "drums", lambda: drums.accumulate_hits(*hits, n_frames=n),
        lambda: drums.accumulate_hits_plain(*hits, n_frames=n),
        x.abs().max())]
    twins = (("lp24_refined", iir_kernels.lp24_refined_blockrate,
              iir_kernels.lp24_refined_blockrate_plain),
             ("lp24", iir_kernels.lp24_blockrate,
              iir_kernels.lp24_blockrate_plain))
    x2, den = iir_kernels._prepare(x, secs, 64)
    for name, kern, plain in twins:
        results.append(compare(name, lambda k=kern: k(x, secs),
                               lambda p=plain: p(x2, *den), x.abs().max()))
    # [64, 65536]: many rows through a sweep that rests near 25 Hz
    g = torch.Generator().manual_seed(0)
    rows, nn = 64, 65536
    t = torch.linspace(0.0, 1.0, nn // 64, dtype=torch.float64) ** 3
    gain_w, secs_w = tiir.lp24_sections(
        (25.0 * 800.0 ** t).float().numpy(), 0.707, 44100.0)
    xw = (torch.randn(rows, nn, generator=g) * 0.3).to(dev)
    xw = xw * tiir.upsample_hold(torch.from_numpy(gain_w).to(dev), nn)
    sw = [tuple(torch.from_numpy(c).to(dev).expand(rows, -1) for c in sec)
          for sec in secs_w]
    xw2, denw = iir_kernels._prepare(xw, sw, 64)
    for name, kern, plain in twins:
        results.append(compare(name, lambda k=kern: k(xw, sw),
                               lambda p=plain: p(xw2, *denw),
                               xw.abs().max()))
    for res in results:
        emit("kernel_vs_twin", **res)
        require(res["bitwise"], f"{res['name']} differs from its twin")

    # each kernel alone at the 3-minute song's shapes
    n, hits, x, secs = kernel_inputs(SONG_MEASURES)
    for name, fn in (
            ("drums", lambda: drums.accumulate_hits(*hits, n_frames=n)),
            ("lp24_refined",
             lambda: iir_kernels.lp24_refined_blockrate(x, secs)),
            ("lp24", lambda: iir_kernels.lp24_blockrate(x, secs))):
        ms, _ = cuda_ms(fn, 5)
        emit("kernel_at_song_size", name=name, frames=n, ms=ms)
    del hits, x, secs

    # ---- 4. the slice through the CLI --------------------------------------
    projects = {
        "north-star": synth.write_project(
            work / "north-star.json",
            synth.north_star_project(SONG_MEASURES, SONG_BPM)),
        "high-sweep": synth.write_project(
            work / "high-sweep.json",
            synth.high_sweep_project(SONG_MEASURES, SONG_BPM)),
    }
    os.environ["GROOVE_ASSETS"] = str(assets)
    counters = (drums.LAUNCHES, iir_kernels.LAUNCHES)
    for c in counters:
        for k in c:
            c[k] = 0
    per_song = {}
    for name, path in projects.items():
        before = {**drums.LAUNCHES, **iir_kernels.LAUNCHES}
        torch.cuda.reset_peak_memory_stats(dev)
        perf = []
        rc = cli.main([str(path), "--wav", "--perf", "--out-dir",
                       str(work / "out"), "--device", "cuda"],
                      perf_out=perf)
        require(rc == 0 and len(perf) == 1, f"cli failed on {name}")
        after = {**drums.LAUNCHES, **iir_kernels.LAUNCHES}
        launches = {k: after[k] - before[k] for k in after}
        wav = Path(perf[0]["wav"])
        audio, rate = read_wav(wav)
        per_song[name] = (launches, perf[0], wav, audio)
        emit("slice", project=name, frames=perf[0]["frames"],
             seconds_of_audio=perf[0]["frames"] / rate,
             setup_s=perf[0]["setup_s"],
             first_render_s=perf[0]["first_render_s"],
             render_s=perf[0]["render_s"], xrt=perf[0]["xrt"],
             max_memory_allocated=torch.cuda.max_memory_allocated(dev),
             wav_bytes=wav.stat().st_size,
             wav_peak=float(abs(audio).max()), launches=launches)
    totals = {k: drums.LAUNCHES.get(k, 0) + iir_kernels.LAUNCHES.get(k, 0)
              for k in ("drums", "lp24_refined", "lp24")}
    ns, hs = per_song["north-star"][0], per_song["high-sweep"][0]
    require(ns["drums"] >= 1 and ns["lp24_refined"] >= 1,
            f"north star launched {ns}")
    require(hs["drums"] >= 1 and hs["lp24"] >= 1, f"high sweep launched {hs}")
    require(ns["lp24"] == 0 and hs["lp24_refined"] == 0,
            f"routing: {ns} {hs}")

    # ---- outputs: right shape, audible, and equal to the twins' render ----
    for name, (_, perf, _, audio) in per_song.items():
        require(audio.shape == (perf["frames"], 2),
                f"{name}: WAV shape {audio.shape}")
        peak = float(abs(audio).max())
        require(0.05 < peak < 1.0, f"{name}: WAV peak {peak}")
        song = SongSettings.from_project_file(projects[name])
        t0 = time.perf_counter()
        q_cpu = Renderer(compile_song(song, paths),
                         device="cpu").render_quantized()
        cpu_s = time.perf_counter() - t0
        q_gpu = (audio * 32768.0).round().astype(q_cpu.dtype)
        diff = int(abs(q_gpu.astype("int32") - q_cpu).max())
        emit("check", project=name, cpu_twin_render_s=cpu_s,
             max_lsb_diff_vs_cpu_twins=diff)
        require(diff == 0, f"{name}: card render differs from the twins")

    sources = {"drums": ("groove_tpu_torch/csrc/drums.cu",
                         "groove_tpu/ops/pallas_drums.py:119"),
               "lp24_refined": ("groove_tpu_torch/csrc/lp24.cu",
                                "groove_tpu/ops/pallas_iir.py:1021"),
               "lp24": ("groove_tpu_torch/csrc/lp24.cu",
                        "groove_tpu/ops/pallas_iir.py:661")}
    kernels = []
    for res in results[:3]:  # the [2, 10 s] main-path shapes
        src, rep = sources[res["name"]]
        kernels.append({"name": res["name"], "route": "cuda", "source": src,
                        "replaces": rep, "launches": totals[res["name"]],
                        "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                        "plain_ms": res["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
