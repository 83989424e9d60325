"""Unattended-daemon soak: run the production App for a long stretch on a
looped file input and record process-health samples (RSS, thread count,
open fds, block cadence, counters, and on the card the PyTorch caching
allocator's reserved and allocated bytes) -- evidence for the reference's
service contract (init.d/rtl_airband.service: a process expected to run for
weeks).

Counterpart of the JAX package's ``scripts/soak.py``: the same scene
machinery (``bench_app.build_scene``), knobs, checks and ``--out`` JSON.

    SOAK_MINUTES=30 SOAK_CHANNELS=2048 python -m rtlsdr_airband_tpu_torch.scripts.soak [--out SOAK.json]
    SOAK_CPU=1 SOAK_MINUTES=0.5 SOAK_CHANNELS=64 python -m rtlsdr_airband_tpu_torch.scripts.soak --out /tmp/soak.json

The input is a file device with speedup_factor = 1 (real-time pacing); at
EOF the input FAILS (reference semantics, input-file.cpp:104-108), so the
soak loops the recording by pointing the file input at a FIFO fed continuously
by a writer thread -- the input thread never sees EOF.

Knobs: SOAK_MINUTES (30), SOAK_CHANNELS (2048), SOAK_BLOCKS_PER_DISPATCH
(16), SOAK_ACTIVE_SLOTS (192), SOAK_FMT (i16), SOAK_RSS_SLACK_MB (64),
SOAK_ECON=1 (fetch_economy = auto), SOAK_SAMPLE_S (15, seconds between
health samples), SOAK_SCENE_SECONDS (30, the looped recording's length),
SOAK_CPU=1 (the plain versions on the CPU).

Pass criteria (exit 1 on a violation):
 - RSS growth from the 10 %-mark sample (at the earliest the first one
   after two chunks were handled) to the last < SOAK_RSS_SLACK_MB;
 - thread and fd counts flat from the 10 %-mark to the end (+/-2);
 - block cadence held: handled blocks >= 97 % of the real-time expectation;
 - the stats file kept being rewritten at its 15 s cadence.
The caching allocator's bytes are reported beside RSS so that growth of the
host and caching on the device are told apart; they are not a check.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

import torch

from .common import device_fields, pick_device, raise_fd_limit


def proc_health():
    """(rss_mb, n_threads, n_fds) from /proc/self (linux)."""
    rss_kb, threads = 0, 0
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss_kb = int(line.split()[1])
            elif line.startswith("Threads:"):
                threads = int(line.split()[1])
    return rss_kb / 1024.0, threads, len(os.listdir("/proc/self/fd"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="SOAK.json", help="where the JSON result goes (default ./SOAK.json)")
    args = ap.parse_args(argv)

    minutes = float(os.environ.get("SOAK_MINUTES", "30"))
    n_channels = int(os.environ.get("SOAK_CHANNELS", "2048"))
    chunk = int(os.environ.get("SOAK_BLOCKS_PER_DISPATCH", "16"))
    slots = int(os.environ.get("SOAK_ACTIVE_SLOTS", "192"))
    fmt = os.environ.get("SOAK_FMT", "i16")
    rss_slack_mb = float(os.environ.get("SOAK_RSS_SLACK_MB", "64"))
    sample_s = float(os.environ.get("SOAK_SAMPLE_S", "15"))
    scene_s = float(os.environ.get("SOAK_SCENE_SECONDS", "30"))
    econ = os.environ.get("SOAK_ECON", "0") == "1"
    device = pick_device(os.environ.get("SOAK_CPU", "0") == "1", "soak", "SOAK_CPU=1")
    if device is None:
        return 1
    cuda = device.type == "cuda"

    from ..app import App
    from ..constants import AGC_EXTRA
    from ..models.flagship import flagship_specs
    from ..runtime.config import load_config
    from .bench_app import CENTER, FS, WAVE_RATE, build_scene, hot_channels, squelch_dbfs

    raise_fd_limit(n_channels + 256)
    freqs = [s.frequency for s in flagship_specs(n_channels, CENTER, FS)]
    hot = hot_channels(n_channels, 0.06)  # the ~6 % open-fraction scene family

    # a SOAK_SCENE_SECONDS recording looped through a FIFO
    hop, W = FS // WAVE_RATE, WAVE_RATE // 8
    total = AGC_EXTRA * hop + round(scene_s * 8) * W * hop + 512
    tmp_dir = tempfile.TemporaryDirectory(prefix="soak_")
    tmp = tmp_dir.name
    scene_path = os.path.join(tmp, "scene.cu8")
    build_scene(scene_path, freqs, hot, CENTER, FS, total, WAVE_RATE)
    with open(scene_path, "rb") as fh:
        scene = fh.read()
    os.remove(scene_path)

    fifo = os.path.join(tmp, "stream.fifo")
    os.mkfifo(fifo)
    stop_feed = threading.Event()

    def feeder():
        # blocks in open() until the reader connects; loops the scene
        with open(fifo, "wb", buffering=0) as f:
            while not stop_feed.is_set():
                try:
                    f.write(scene)
                except BrokenPipeError:
                    return

    tf = threading.Thread(target=feeder, daemon=True, name="soak-feeder")
    tf.start()

    thr_dbfs = squelch_dbfs()
    stats_path = os.path.join(tmp, "stats.txt")
    chans = ", ".join(
        f'{{ freq = {f}; modulation = "am"; squelch_threshold = {thr_dbfs}; '
        f'outputs: ( {{ type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = {21000 + (i % 8000)}; }} ); }}'
        for i, f in enumerate(freqs)
    )
    cfg_text = (
        f'fft_size = 512;\nwave_rate = {WAVE_RATE};\nstats_filepath = "{stats_path}";\n'
        f"blocks_per_dispatch = {chunk};\nactive_fetch_slots = {slots};\n"
        f'fetch_audio_fmt = "{fmt}";\nsuppress_fade_tails = true;\nfetch_meta_per_chunk = true;\n'
        + ('fetch_economy = "auto";\n' if econ else "")
        + f'devices: ( {{ type = "file"; filepath = "{fifo}"; centerfreq = {CENTER}; '
        f'sample_rate = {FS}; sample_format = "u8"; speedup_factor = 1.0; '
        f"channels: ( {chans} ); }} );\n"
    )
    cfg_path = os.path.join(tmp, "soak.conf")
    with open(cfg_path, "w") as f:
        f.write(cfg_text)

    app = App(load_config(cfg_path), device=device.type)
    t0 = time.perf_counter()
    for rt in app.devices:
        rt.pipeline.warm(chunk)
    t_warm = time.perf_counter() - t0
    print(f"[soak] warm {t_warm:.1f}s on {device}; running {minutes:g} min", file=sys.stderr, flush=True)

    blocks = [0]
    orig = app._handle_block

    def counting(rt, out):
        orig(rt, out)
        blocks[0] += 1

    app._handle_block = counting

    samples = []
    stats_mtimes = set()
    sampling = threading.Event()

    def sampler():
        while not sampling.is_set():
            rss, thr, fds = proc_health()
            samples.append(dict(
                t=time.perf_counter() - t0, rss_mb=rss, threads=thr, fds=fds, blocks=blocks[0],
                overflow=int(sum(rt.pipeline.gather_overflow_count for rt in app.devices)),
                ring_overflow=int(sum(rt.input.ring.overflow_count for rt in app.devices)),
                cuda_reserved_mb=torch.cuda.memory_reserved(device) / 2**20 if cuda else None,
                cuda_allocated_mb=torch.cuda.memory_allocated(device) / 2**20 if cuda else None,
            ))
            if os.path.exists(stats_path):
                stats_mtimes.add(round(os.path.getmtime(stats_path)))
            print(f"[soak] {samples[-1]}", file=sys.stderr, flush=True)
            sampling.wait(sample_s)

    ts = threading.Thread(target=sampler, daemon=True, name="soak-sampler")

    t0 = time.perf_counter()
    ts.start()
    try:
        app.run(max_seconds=minutes * 60.0)
    finally:
        wall = time.perf_counter() - t0
        sampling.set()
        stop_feed.set()
        ts.join(timeout=30)
        if os.path.exists(stats_path):  # the rewrite stop() makes
            stats_mtimes.add(round(os.path.getmtime(stats_path)))
        tmp_dir.cleanup()

    # analysis: the 10 %-mark sample (or the first after the pipeline filled,
    # two chunks handled, if that is later: a short soak's 10 % mark falls
    # in its start-up) against the last
    filled = next((i for i, sm in enumerate(samples) if sm["blocks"] >= 2 * chunk), len(samples) - 1)
    i10 = min(len(samples) - 1, max(1, len(samples) // 10, filled))
    base, last = samples[i10], samples[-1]
    rss_growth = last["rss_mb"] - base["rss_mb"]
    thread_drift = last["threads"] - base["threads"]
    fd_drift = last["fds"] - base["fds"]
    # the real-time expectation less the start-up fill (prime and the first
    # chunk) and the last partial chunk still in flight at the cutoff
    expected_blocks = (wall - 5.0) / 0.125 - 2 * chunk
    checks = {
        "rss_flat": bool(rss_growth < rss_slack_mb),
        "threads_flat": bool(abs(thread_drift) <= 2),
        "fds_flat": bool(abs(fd_drift) <= 2),
        "cadence_held": bool(blocks[0] >= expected_blocks * 0.97),
        "stats_cadence": bool(len(stats_mtimes) >= (wall / 15.0) * 0.8),
    }
    out = {
        "metric": "soak",
        "minutes": wall / 60.0,
        "platform": "gpu" if cuda else "cpu",
        **device_fields(device),
        "n_channels": n_channels,
        "blocks_handled": blocks[0],
        "blocks_expected": expected_blocks,
        "rss_mb_start": base["rss_mb"],
        "rss_mb_end": last["rss_mb"],
        "rss_growth_mb": rss_growth,
        "cuda_reserved_mb_start": base["cuda_reserved_mb"],
        "cuda_reserved_mb_end": last["cuda_reserved_mb"],
        "thread_drift": thread_drift,
        "fd_drift": fd_drift,
        "gather_overflow_total": last["overflow"],
        "ring_overflow_total": last["ring_overflow"],
        "stats_rewrites": len(stats_mtimes),
        "checks": checks,
        "pass": bool(all(checks.values())),
        "samples": samples[:: max(1, len(samples) // 40)],
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items() if k != "samples"}), flush=True)
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
