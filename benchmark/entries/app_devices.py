"""Entry ``app_devices``: the application, ``app.py::App``, with several SDR
devices, each with its own ring, ``Pipeline``, streams and sinks, serviced
by the App's own single loop (``App._service_once``), as upstream's demod
thread visits its devices in turn (``rtl_airband.cpp``, ``next_device``).

The configuration lists the devices under ``dongles``: their ``centers``,
the first of which is ``center_freq``.  Every device holds the
configuration's ``channels`` at the same offsets from its own centre, so
the reference reads any device's channels from the configuration as it
stands.  Device k reads a FIFO of its own, filled unpaced by a
``FifoWriter`` of the ``app`` entry (``entries/app.py``, whose pieces this
entry imports) with a segment drawn from the run's seed and k, so no two
devices carry the same air.

The window is counted in blocks of air: a block index counts once, when
every device has handled it.  It runs from the end of the first chunk of
air to the end of the first chunk of air whose handling starts
``--seconds`` later on any device.  ``card_ms.app`` is the card's time a
block of air by its own clock: the profiler's busy time of the card (the
union of every kernel and copy of every device) from the first chunk every
device dispatched in the window to the last, over the blocks of air
between; the profiler runs in every run on the card.  The union of the
chains' own intervals (CUDA events on each pipeline's stream before and
after each ``pipeline_chain``, read against one reference event), the
``app`` entry's measure with one device, is reported beside it as the
counter ``chain_union_ms``: with ten devices it is bound by the host's
launches, and spread by a sixth from run to run where the busy time did not.

Checked: for a sample of channels spread over the devices, each device's
block 0 against the reference from its stream's start, and a block drawn
from the seed and the window's last block, each from the state it started
from; for each, what the sampled channels' sinks received, besides the
block program's outputs.  ``failed`` counts the window's blocks of air in
which any device's slots overflowed.
"""

from __future__ import annotations

import os
import resource
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

from benchmark.capture import OUTPUTS, case
from benchmark.harness import HERE, Profile, load_module

_app = load_module(HERE / "entries" / "app.py", "benchmark_entry_app")


def device_seed(seed: int, k: int) -> int:
    """The seed of device ``k``'s segment, drawn from the run's seed."""
    return int(np.random.SeedSequence([int(seed), int(k)]).generate_state(1, np.uint64)[0])


def channel_offsets(cfg: dict) -> np.ndarray:
    """Every device's channels as offsets from its centre, in Hz."""
    from benchmark.reference.channel import channel_frequencies

    return channel_frequencies(cfg) - int(cfg["center_freq"])


def config_text(cfg: dict, fifos: list[str]) -> str:
    """The App's libconfig text: one ``file`` device a FIFO, at its centre,
    a ``udp_stream`` sink a channel (ports counted over every device)."""
    from benchmark.reference.channel import channel_spec

    app = cfg["app"]
    C = cfg["channels"]["count"]
    keys = []
    for i in range(C):
        spec = channel_spec(cfg, i)
        keys.append("".join(f" {_app.CONFIG_KEYS[k]} = {v!r};".replace("'", '"') for k, v in vars(spec).items()
                            if k in _app.CONFIG_KEYS and v not in (0, 0.0, None)))
    offsets = channel_offsets(cfg)
    devices = []
    for k, (center, fifo) in enumerate(zip(cfg["dongles"]["centers"], fifos)):
        chans = ", ".join(f'{{ freq = {int(center + offsets[i])};{keys[i]} outputs: ( {{ type = "udp_stream"; '
                          f'dest_address = "127.0.0.1"; dest_port = {app["udp_base_port"] + k * C + i}; }} ); }}'
                          for i in range(C))
        devices.append(f'{{ type = "file"; filepath = "{fifo}"; centerfreq = {int(center)}; sample_rate = {cfg["sample_rate"]}; '
                       f'sample_format = "{cfg["sample_format"]}"; speedup_factor = 0.0; channels: ( {chans} ); }}')
    return (
        f"fft_size = {cfg['fft_size']};\nwave_rate = {cfg['wave_rate']};\n"
        f"blocks_per_dispatch = {app['blocks_per_dispatch']};\nactive_fetch_slots = {app['active_fetch_slots']};\n"
        f'fetch_audio_fmt = "{app["fetch_audio_fmt"]}";\n'
        f"suppress_fade_tails = {str(app['suppress_fade_tails']).lower()};\n"
        f"fetch_meta_per_chunk = {str(app['fetch_meta_per_chunk']).lower()};\n"
        f"multiple_demod_threads = {str(cfg['multiple_demod_threads']).lower()};\n"
        f"devices: ( {', '.join(devices)} );\n"
    )


class DeviceTaps:
    """``capture.BlockTap`` for several pipelines: ``pipeline_block`` and
    ``pipeline_chain`` are wrapped once, and each call is attributed to the
    device whose ``Pipeline._dispatch`` runs it.  ``devices[k].kept`` holds
    device k's blocks as ``BlockTap.kept`` does (``capture.case`` reads
    it); ``chains`` holds, on the card, each chain's (device, first block,
    blocks, host start, start event, end event)."""

    def __init__(self, pipelines: list, keep: set[int], chunk: int, timed: bool, spans, recent: int = 3):
        import torch

        from rtlsdr_airband_tpu_torch.runtime import pipeline

        self._mod = pipeline
        self._orig = (pipeline.pipeline_block, pipeline.pipeline_chain)
        self.keep = keep  # the caller may add to it while the taps run
        self.devices = [SimpleNamespace(kept={}, calls=0) for _ in pipelines]
        self.chains: list[tuple] = []
        self._now: int | None = None  # the device whose dispatch runs
        block, chain = self._orig

        def tapped(x, bins, window, params, state, **kw):
            st, out = block(x, bins, window, params, state, **kw)
            if self._now is not None:
                d = self.devices[self._now]
                b = d.calls
                if b in self.keep or (b + 1) % chunk == 0:
                    d.kept[b] = (state, {k: out[k] for k in OUTPUTS}, st)
                    ends = sorted(k for k in d.kept if k not in self.keep)
                    for k in ends[:-recent]:
                        del d.kept[k]
                d.calls += 1
            return st, out

        def timed_chain(*a, **kw):
            if not timed or self._now is None:
                return chain(*a, **kw)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            b0, t = self.devices[self._now].calls, time.perf_counter()
            e0.record()  # on the current stream: the pipeline's own, inside its dispatch
            out = chain(*a, **kw)
            e1.record()
            self.chains.append((self._now, b0, int(kw["k_blocks"]), t, e0, e1))
            return out

        for k, p in enumerate(pipelines):
            p._dispatch = self._attributed(k, p._dispatch, spans)
        pipeline.pipeline_block, pipeline.pipeline_chain = tapped, timed_chain

    def _attributed(self, k: int, dispatch, spans):
        def dispatched(*a, **kw):
            self._now, t0 = k, time.perf_counter()
            try:
                return dispatch(*a, **kw)
            finally:
                self._now = None
                spans.add("dispatch", t0, time.perf_counter())

        return dispatched

    def close(self) -> None:
        self._mod.pipeline_block, self._mod.pipeline_chain = self._orig


def union_ms(intervals: list[tuple[float, float]]) -> float:
    """The length of the union of [start, end] intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def run(ctx) -> None:
    import torch

    from rtlsdr_airband_tpu_torch.app import App
    from rtlsdr_airband_tpu_torch.runtime.config import load_config

    from benchmark.program_trace import window_count, window_records
    from benchmark.scene import make_scene

    cfg = ctx.config
    centers = cfg["dongles"]["centers"]
    D, C = len(centers), cfg["channels"]["count"]
    if D != cfg["dongles"]["count"] or centers[0] != cfg["center_freq"]:
        raise ValueError("the configuration's dongles: count and centers disagree, or center_freq is not the first centre")
    if cfg["multiple_demod_threads"]:
        raise ValueError("the app_devices entry drives the App's single loop: multiple_demod_threads must be false")
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = D * C + 1024 if hard == resource.RLIM_INFINITY else min(hard, D * C + 1024)
    if soft != resource.RLIM_INFINITY and soft < want:
        resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))

    scenes = [make_scene(cfg, ctx.traffic, device_seed(ctx.seed, k), ctx.device) for k in range(D)]
    datas = [s.host for s in scenes]
    W = scenes[0].W
    ctx.mark("scene")
    with tempfile.TemporaryDirectory(prefix="bench_app_devices_") as tmp:
        fifos = [os.path.join(tmp, f"dongle{k}.c{cfg['sample_format']}") for k in range(D)]
        for f in fifos:
            os.mkfifo(f)
        conf = os.path.join(tmp, "cell.conf")
        with open(conf, "w") as f:
            f.write(config_text(cfg, fifos))
        app = App(load_config(conf), device=ctx.device.type)
        ctx.mark("program")
        rts = app.devices
        pipes = [rt.pipeline for rt in rts]
        if len(rts) != D or any(p.C != C for p in pipes):
            raise RuntimeError(f"the App built {len(rts)} devices of {[p.C for p in pipes]} channels, not {D} of {C}")
        chunk = max(1, int(pipes[0].cfg.chunk_blocks))
        for p in pipes:
            p.warm()
        ctx.mark("warm")

        # the sample: the cell's channels spread over the devices, the odd ones to devices drawn from the seed
        n_check = ctx.workload["check"]["channels"]
        per = np.full(D, n_check // D)
        per[ctx.rng.choice(D, n_check % D, replace=False)] += 1
        users = [ctx.sample_channels(scenes[k], int(per[k])) for k in range(D)]
        dev_idx = [np.argsort(p._order)[u] for p, u in zip(pipes, users)]
        target = ctx.draw_block(chunk, int(ctx.seconds * 4))
        keep = {0, target}
        taps = DeviceTaps(pipes, keep, chunk, ctx.on_card, ctx.spans)
        got = [{} for _ in range(D)]  # per device: block -> what the sampled channels' sinks received

        def recording(b: int) -> None:
            for k in range(D):
                got[k][b] = dict(sent=np.zeros(len(users[k]), bool), audio=np.zeros((W, len(users[k])), np.float32))

        for b in (0, target):
            recording(b)
        cur = [-1] * D  # the block each device is handling
        for k, rt in enumerate(rts):
            for j, u in enumerate(users[k]):
                sink = rt.channels[u].outputs.udps[0]

                def record(left, right=None, _w=sink.write, _k=k, _j=j):
                    rec = got[_k].get(cur[_k])
                    if rec is not None:
                        rec["sent"][_j] = True
                        rec["audio"][:, _j] = left
                    _w(left, right)

                sink.write = record

        index = {id(rt): k for k, rt in enumerate(rts)}
        handled_n = [0] * D  # blocks each device has handled
        overflowed = [[] for _ in range(D)]
        stamps: list[float] = []  # when each block of air had been handled by every device
        state = dict(end=None, last=None, seen_end=-1)
        handle = app._handle_block

        def handled(rt, out):
            k = index[id(rt)]
            b = handled_n[k]
            t0 = time.perf_counter()
            if (b + 1) % chunk == 0 and b > state["seen_end"]:  # the first device to reach a chunk's end decides
                state["seen_end"] = b
                if state["last"] is None and ctx.window_start is not None and t0 - ctx.window_start >= ctx.seconds:
                    state["last"] = b
                    keep.add(b)
                    recording(b)
            cur[k] = b
            handle(rt, out)
            t1 = time.perf_counter()
            ctx.spans.add("handler", t0, t1)
            overflowed[k].append(int(out.get("gather_overflow", 0)))
            handled_n[k] = b + 1
            while min(handled_n) > len(stamps):
                a = len(stamps)
                stamps.append(t1)
                if a == chunk - 1:
                    ctx.begin_window(t1)
                elif a == state["last"]:
                    state["end"] = t1
                    ctx.spans.on = False

        app._handle_block = handled
        writers = [_app.FifoWriter(f, d) for f, d in zip(fifos, datas)]
        for w in writers:
            w.start()
        ref, own = None, None
        if ctx.on_card:
            ref = torch.cuda.Event(enable_timing=True)
            ref.record()
            torch.cuda.synchronize()
            if not ctx.trace:  # card_ms.app reads the device's trace in every run
                own = Profile(ctx.device, ctx.spans)
                own.start()
        ctx.start_profiler()
        try:
            app.start()
            deadline = time.perf_counter() + ctx.seconds + 240.0
            while time.perf_counter() < deadline:
                if state["end"] is not None and len(stamps) > target:
                    break
                if not all(rt.alive for rt in rts):
                    raise RuntimeError("a device's input stopped")
                if not app._service_once():
                    time.sleep(0.001)
            if ctx.on_card:
                torch.cuda.synchronize()
        finally:
            for w in writers:
                w.stop()
            app.stop()
            taps.close()
            if own is not None and (state["end"] is None or sys.exc_info()[0] is not None):
                own.prof.stop()
        if state["end"] is None:
            raise RuntimeError(f"the window did not close: {len(stamps)} blocks of air handled, {handled_n} a device")
        ctx.end_window(state["end"])
        tr = own.stop(ctx.window_start, state["end"]) if own is not None else ctx.trace_result

    first, last, end = chunk, state["last"], state["end"]
    n = last - first + 1
    ctx.e2e["setup_s"] = ctx.window_start - ctx.t_start
    ctx.attempted = ctx.blocks_in_window = n
    if ref is not None:
        chunks: dict[int, list] = {}  # first block -> the chains of it dispatched in the window
        for k, b0, kb, t, e0, e1 in taps.chains:
            if ctx.window_start <= t <= end:
                chunks.setdefault(b0, []).append((k, kb, t, e0, e1))
        whole = [chunks[b0] for b0 in sorted(chunks) if len({c[0] for c in chunks[b0]}) == D]
        if whole:
            blocks = sum(c[0][1] for c in whole)
            intervals = [(ref.elapsed_time(e0), ref.elapsed_time(e1)) for c in whole for _, _, _, e0, e1 in c]
            ctx.counters.update(chain_union_ms=union_ms(intervals) / blocks)
            if tr is not None and tr.found and len(whole) > 1:  # the busy time from the first whole chunk's dispatch to the last's
                t_first, t_last = min(c[2] for c in whole[0]), min(c[2] for c in whole[-1])
                ctx.e2e["card_ms.app"] = tr.busy_between(t_first, t_last) / (blocks - whole[-1][0][1]) * 1e3
    # K1's launches a block of air: one a device, at its own channel count
    ctx.counters.update(k1_launches=[[p.W, p.C_dev, sum(int(s.ctcss > 0) for s in p.specs)] for p in pipes],
                        realtime_x=n * W / cfg["wave_rate"] / (end - ctx.window_start),
                        blocks_a_device=list(handled_n), ring_full_waits=sum(int(rt.input.ring.overflow_count) for rt in rts),
                        opened=sum(int(st.squelch_open_count > 0) for rt in rts for ch in rt.channels for st in ch.stats),
                        d2h_bytes_per_block_of_air=sum(p.fetched_bytes / max(1, p.blocks_processed) for p in pipes),
                        checked_blocks=sorted({0, target, last}))
    recs = window_records(ctx)
    rounds = sum(1 for r in recs or () if r[0] == "app.round")
    serviced = window_count(ctx, "app.devices_serviced")
    if rounds and serviced is not None:
        ctx.counters.update(devices_serviced_per_round=serviced / rounds, rounds_per_block_of_air=rounds / n)
    ctx.failed = sum(1 for b in range(first, last + 1) if any(o[b] > 0 for o in overflowed))
    for k, d in enumerate(taps.devices):
        if last not in d.kept:
            raise RuntimeError(f"device {k}'s tap no longer holds the window's last block {last}")
    ctx.cases = [case(taps.devices[k], b, users[k], dev_idx[k], scenes[k], got[k][b])
                 for k in range(D) if len(users[k]) for b in sorted({0, target, last})]
