"""App-level benchmark: the whole production path on the card.

Counterpart of the JAX package's ``scripts/bench_app.py``: the same scene,
knobs, protocol and JSON keys.  Unlike ``bench.py`` (the block program alone,
checksums on the device), this drives the application as a user runs it:
libconfig text -> load_config -> App -> file input thread -> ring buffer ->
Pipeline (chunked dispatch, fetches on a copy stream) -> host block handler
-> a UDP sink a channel.  What one block costs end to end, the host's work
and the device-to-host copies included.

Scene: a noise floor and AM carriers on ~0.4 % of the channels (at least 4),
keyed on after a quiet lead-in so a handful of squelches open and their
sinks send audio; one channel carries CTCSS so the demod runs with its
Goertzel banks, as in bench.py.

Protocol: ``speedup_factor = 0`` (the file is read unpaced: the input is
never the bottleneck), the App loop over a BENCH_APP_SECONDS recording, a
timestamp a handled block, the first chunk dropped (pipeline fill), the
steady wall a block reported.

Knobs: BENCH_APP_CHANNELS (default 2048), BENCH_APP_SECONDS (24),
BENCH_APP_BLOCKS_PER_DISPATCH (16, as bench.py), BENCH_APP_ACTIVE_SLOTS,
BENCH_APP_FMT (f32|i16|i8bf), BENCH_APP_I16=1, BENCH_APP_SUPPRESS=1
(fade-tail suppression), BENCH_APP_METAPC=1 (meta once a chunk),
BENCH_APP_HOT (carriers), BENCH_APP_OPEN_FRAC (carriers sized for a fixed
open fraction, ~62 x frac, whatever the channel count), BENCH_APP_PACED=1
(real-time pacing and ingest-to-handled latency), BENCH_APP_ECON=1
(fetch_economy = auto, its rungs warmed first), BENCH_APP_MOT=1
(multiple_output_threads), BENCH_APP_DEVICES=N > 1 (``mesh_devices = N``:
the population over a mesh of N GPUs), BENCH_APP_CPU=1 (the plain versions
on the CPU; numbers meaningless, for checking the script).

    python -m rtlsdr_airband_tpu_torch.scripts.bench_app
    BENCH_APP_CPU=1 BENCH_APP_CHANNELS=64 BENCH_APP_SECONDS=2 python -m rtlsdr_airband_tpu_torch.scripts.bench_app

Prints ONE JSON line, ``{"metric": "app_block_time", "value": ..., "unit":
"ms/block", ...}``, plus ``device`` and ``power_limit``.

Reference analog: the thread-decoupled production loop
src/rtl_airband.cpp:1056-1112 of the reference, feeding demod and output
threads.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

from .common import device_fields, pick_device, raise_fd_limit

CENTER, FS, WAVE_RATE = 120_000_000, 2_560_000, 16000


def build_scene(path: str, freqs_hz: list[int], hot: list[int], center: int, fs: int, total: int, wave_rate: int) -> None:
    from ..utils.siggen import complex_noise

    # Scene design notes (each clause prevents a failure mode that
    # spuriously opened thousands of channels' squelch):
    #  - noise well above 1 u8 LSB so the floor isn't quantization-limited;
    #  - carrier amplitudes scaled so the SUM stays inside the u8 range
    #    (clipping splatter is broadband);
    #  - the modulating tone synthesized at the FULL IQ rate -- zero-order-
    #    hold upsampling of audio-rate tones leaves 16 kHz-spaced spectral
    #    replica combs across the whole band;
    #  - carriers key ON after a quiet lead-in: with an always-on carrier
    #    the min-tracking noise floor converges onto the carrier itself and
    #    squelch never opens (reference semantics, squelch.cpp:477-490).
    z = complex_noise(total, 0.02, seed=11)
    t_full = np.arange(total, dtype=np.float64) / fs
    ampl = min(0.4, 0.5 / np.sqrt(max(1, len(hot))))
    gate = (np.arange(total) >= int(total * 0.25)).astype(np.float32)
    for k, ci in enumerate(hot):
        env = 1.0 + 0.5 * 0.7 * np.sin(2 * np.pi * (500.0 + 130.0 * k) * t_full)
        ph = 2 * np.pi * (freqs_hz[ci] - center) * t_full
        z += (ampl * env * np.exp(1j * ph)).astype(np.complex64) * gate
    iq = np.empty(total * 2, np.float32)
    iq[0::2], iq[1::2] = z.real, z.imag
    u8 = np.clip(np.round(iq * 127.5 + 127.5), 0, 255).astype(np.uint8)
    u8.tofile(path)


def hot_channels(n_channels: int, open_frac: float, n_hot: int = 0) -> list[int]:
    """The carriers' channels, spread evenly over the population.  Each
    carrier opens its FFT-bin group (n_channels / 512 channels) and the
    Blackman-Harris-7 mainlobe neighbours (~8.2 bins' worth), so at 8192
    channels one opens ~80-150: a fixed open fraction f takes ~62 f
    carriers whatever the count."""
    if open_frac > 0:
        n_hot = max(1, round(62.0 * open_frac))
    else:
        n_hot = n_hot or max(4, n_channels // 256)
    return [int(i) for i in np.linspace(0, n_channels - 1, n_hot).astype(int)]


def squelch_dbfs() -> float:
    """A manual squelch threshold midway (log scale) between the noise bin
    level (sigma * sqrt(sum w^2) ~ 0.15) and the carrier bin level (~ ampl *
    sum(w) / 2): a deterministic open set whatever the noise floor does."""
    from ..ops.levels import level_to_dbfs

    return round(float(level_to_dbfs(1.0, 512)), 1)


def main() -> int:
    n_channels = int(os.environ.get("BENCH_APP_CHANNELS", "2048"))
    seconds = float(os.environ.get("BENCH_APP_SECONDS", "24"))
    chunk = int(os.environ.get("BENCH_APP_BLOCKS_PER_DISPATCH", "16"))
    slots = int(os.environ.get("BENCH_APP_ACTIVE_SLOTS", "0"))
    mesh_devices = int(os.environ.get("BENCH_APP_DEVICES", "1"))
    i16 = os.environ.get("BENCH_APP_I16", "0") == "1"
    fmt = os.environ.get("BENCH_APP_FMT", "")  # '' | f32 | i16 | i8bf
    suppress = os.environ.get("BENCH_APP_SUPPRESS", "0") == "1"
    metapc = os.environ.get("BENCH_APP_METAPC", "0") == "1"
    paced = os.environ.get("BENCH_APP_PACED", "0") == "1"
    econ = os.environ.get("BENCH_APP_ECON", "0") == "1"
    # per-device sink worker threads move the per-block UDP work off the
    # block loop (reference: rtl_airband.cpp:817-819)
    mot = os.environ.get("BENCH_APP_MOT", "0") == "1"
    open_frac = float(os.environ.get("BENCH_APP_OPEN_FRAC", "0") or 0)
    device = pick_device(os.environ.get("BENCH_APP_CPU", "0") == "1", "bench_app", "BENCH_APP_CPU=1")
    if device is None:
        return 1

    from ..app import App
    from ..constants import AGC_EXTRA
    from ..models.flagship import flagship_specs
    from ..runtime.config import load_config

    raise_fd_limit(n_channels + 256)
    freqs = [s.frequency for s in flagship_specs(n_channels, CENTER, FS)]
    hot = hot_channels(n_channels, open_frac, int(os.environ.get("BENCH_APP_HOT", "0")))

    # size the recording so the chunked dispatch consumes it exactly: the
    # priming step eats AGC_EXTRA frames, then n_chunks full chunks; a
    # ragged tail would leave a short chunk for flush() inside the window
    hop, fft_size, W = FS // WAVE_RATE, 512, WAVE_RATE // 8
    n_chunks = max(1, round(seconds / 0.125 / chunk))
    total = AGC_EXTRA * hop + n_chunks * chunk * W * hop + (fft_size - hop)

    with tempfile.TemporaryDirectory(prefix="bench_app_") as tmp:
        iq_path = os.path.join(tmp, "scene.cu8")
        build_scene(iq_path, freqs, hot, CENTER, FS, total, WAVE_RATE)
        thr_dbfs = squelch_dbfs()
        # one CTCSS channel so the demod runs with its Goertzel banks, as in bench.py
        chans = []
        for i, f in enumerate(freqs):
            extra = " ctcss = 100.0;" if i == min(hot) else ""
            chans.append(
                f'{{ freq = {f}; modulation = "am";{extra} squelch_threshold = {thr_dbfs}; '
                f'outputs: ( {{ type = "udp_stream"; '
                f'dest_address = "127.0.0.1"; dest_port = {20000 + (i % 8000)}; }} ); }}'
            )
        speedup = "1.0" if paced else "0.0"
        cfg_text = (
            f"fft_size = 512;\nwave_rate = {WAVE_RATE};\n"
            f"blocks_per_dispatch = {chunk};\nactive_fetch_slots = {slots};\n"
            + (f"mesh_devices = {mesh_devices};\n" if mesh_devices > 1 else "")
            + ("fetch_audio_i16 = true;\n" if i16 else "")
            + (f'fetch_audio_fmt = "{fmt}";\n' if fmt else "")
            + ("suppress_fade_tails = true;\n" if suppress else "")
            + ("fetch_meta_per_chunk = true;\n" if metapc else "")
            + ('fetch_economy = "auto";\n' if econ else "")
            + ("multiple_output_threads = true;\n" if mot else "")
            + f'devices: ( {{ type = "file"; filepath = "{iq_path}"; centerfreq = {CENTER}; '
            f'sample_rate = {FS}; sample_format = "u8"; speedup_factor = {speedup}; '
            f'channels: ( {", ".join(chans)} ); }} );\n'
        )
        cfg_path = os.path.join(tmp, "bench.conf")
        with open(cfg_path, "w") as f:
            f.write(cfg_text)

        t0 = time.perf_counter()
        cfg = load_config(cfg_path)
        t_parse = time.perf_counter() - t0

        app = App(cfg, device=device.type)
        # warm every device's chain before streaming starts: an unpaced file
        # input would drain (and overflow the ring) during a first dispatch
        t0 = time.perf_counter()
        for rt in app.devices:
            rt.pipeline.warm(1 if (rt.scan is not None or any(c.afc for c in rt.channels)) else chunk)
        if econ:
            # warm the overflow target (roomy) rung and the down-neighbour so
            # the shift the bench shows does not stall mid-run
            for rt in app.devices:
                if rt.economy is not None:
                    for ti in sorted({0, *rt.economy.neighbors()} - {rt.economy.idx}):
                        r = rt.economy.rungs[ti]
                        print(f"[bench_app] warming econ rung {r}", file=sys.stderr, flush=True)
                        rt.pipeline.warm(chunk, slots=r.slots, fmt=r.fmt)
        t_warm = time.perf_counter() - t0
        print(f"[bench_app] warm {t_warm:.1f}s on {device}", file=sys.stderr, flush=True)

        stamps: list[float] = []
        orig = app._handle_block

        def timed(rt, out):
            orig(rt, out)
            stamps.append(time.perf_counter())
            n = len(stamps)
            if n == 1 or n % 64 == 0:
                print(f"[bench_app] block {n} @ t+{stamps[-1] - t0:.1f}s", file=sys.stderr, flush=True)

        app._handle_block = timed

        started_at = {}
        if paced:
            # the instant the paced reader starts (its pacing origin), so
            # per-block availability times are honest
            for rt in app.devices:
                def make(idx, orig_start):
                    def s():
                        started_at[idx] = time.perf_counter()
                        return orig_start()

                    return s

                rt.input.start = make(rt.stats.index, rt.input.start)

        t0 = time.perf_counter()
        if paced:
            # real-time ingest: the service loop run here, so the stream
            # origin is known; blocks must be handled as fast as they arrive
            app.start()
            try:
                while not app.do_exit:
                    worked = app._service_once()
                    if not any(rt.alive for rt in app.devices):
                        break
                    if time.perf_counter() - t0 > 600.0:
                        break
                    if not worked:
                        time.sleep(0.002)
            finally:
                app.stop()
        else:
            app.run(max_seconds=600.0)
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    n = len(stamps)
    expected = n_chunks * chunk
    # steady state: drop the first chunk (pipeline fill)
    k = min(2 * chunk, n // 2)
    steady_ms = (stamps[-1] - stamps[k - 1]) / (n - k) * 1e3 if n > k > 0 else float("nan")
    block_realtime_ms = 125.0
    opened = sum(int(st.squelch_open_count > 0) for rt in app.devices for ch in rt.channels for st in ch.stats)
    audio_fmt = fmt or ("i16" if i16 else "f32")

    result = {
        "metric": "app_block_time",
        "value": steady_ms,
        "unit": "ms/block",
        "vs_baseline": block_realtime_ms / steady_ms,  # realtime factor
        "detail": {
            "n_channels": n_channels,
            "n_devices": mesh_devices,
            "per_device_block_ms": steady_ms,
            "blocks": n,
            "blocks_expected": expected,
            "wall_s": wall,
            "config_parse_s": t_parse,
            "compile_s": t_warm,
            "blocks_per_dispatch": chunk,
            "active_fetch_slots": slots,
            "fetch_audio_i16": i16,
            "hot_channels": len(hot),
            "channels_opened": opened,
            "gather_overflows": sum(rt.pipeline.gather_overflow_count for rt in app.devices),
            "realtime_channel_capacity": int(n_channels * block_realtime_ms / steady_ms) if n > k > 0 else 0,
            "fetch_mb_per_block": W * (slots or n_channels) * {"f32": 4, "i16": 2, "i8bf": 1}[audio_fmt] / 1e6,
            "d2h_bytes_per_block": sum(rt.pipeline.fetched_bytes for rt in app.devices)
            / max(1, sum(rt.pipeline.blocks_processed for rt in app.devices)),
            "audio_fmt": audio_fmt,
            "suppress_fade_tails": suppress,
            "meta_per_chunk": metapc,
            "open_frac_requested": open_frac or None,
        },
        **device_fields(device),
    }
    if paced and n > k and started_at:
        # ingest->handled latency a steady block: block b's last input sample
        # is available at t_stream + (prime + (b+1) W) hop / fs
        t_stream = started_at.get(0, t0)
        lat = np.asarray([(stamps[b] - (t_stream + (AGC_EXTRA + (b + 1) * W) * hop / FS)) * 1e3 for b in range(k, n)])
        d = result["detail"]
        d["paced"] = True
        d["latency_ms_p50"] = float(np.percentile(lat, 50))
        d["latency_ms_p95"] = float(np.percentile(lat, 95))
        d["latency_ms_max"] = float(lat.max())
        # a stall early in the run leaves a backlog when the block cost is
        # near the 125 ms budget; the last third is the steady tail
        tail = lat[-max(8, len(lat) // 3) :]
        d["latency_ms_tail_p50"] = float(np.percentile(tail, 50))
        d["latency_ms_tail_p95"] = float(np.percentile(tail, 95))
    if econ:
        for rt in app.devices:
            if rt.economy is not None:
                result["detail"]["economy_shifts"] = rt.economy.shift_count
                result["detail"]["economy_final_rung"] = str(rt.economy.rung)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
