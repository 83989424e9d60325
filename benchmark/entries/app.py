"""Entry ``app``: the application, ``app.py::App``, as a user runs it.

The configuration's libconfig text (one ``udp_stream`` sink a channel to
127.0.0.1; the device's ``sample_format`` and, where the configuration gives
one, ``fullscale``) is written to ``TMPDIR`` and loaded by the program; its ``file``
device reads a FIFO there, unpaced, which a thread of the benchmark fills
with the scene's segment over and over, so nothing of the stream is written
to disk.  The App runs its own loop (ring -> ``Pipeline.feed`` ->
``_handle_block`` -> sinks), served here as ``scripts/bench_app.py`` serves
it.  The window runs from the end of the first chunk handled to the end of
the first chunk whose handling starts ``--seconds`` later; ``realtime_x`` is
the air those blocks hold over that time (a per-layer metric: the host's
pace swings with its neighbours).  ``card_ms.app`` is the card's time a
block by its own clock: CUDA events on the pipeline's stream before and
after each ``pipeline_chain`` (every kernel of a chunk's blocks, after its
input's copy and before its fetch), summed over the chunks dispatched in
the window, over their blocks.  It holds the waits of the card for the
chain's launches; a traced run gives the trace's busy time of the same
chunks beside it (``card_busy_ms``).

Checked: block 0 against the reference from the stream's start; a block
drawn from the seed and the window's last block, each from the state it
started from; for each, what the sampled channels' sinks received, besides
the block program's outputs.
"""

from __future__ import annotations

import fcntl
import os
import resource
import select
import tempfile
import threading
import time

import numpy as np

CONFIG_KEYS = {"modulation": "modulation", "bandwidth": "bandwidth", "notch": "notch", "ctcss": "ctcss",
               "squelch_threshold_dbfs": "squelch_threshold"}


class FifoWriter(threading.Thread):
    """Writes ``data`` into the FIFO at ``path`` over and over until stopped."""

    def __init__(self, path: str, data: np.ndarray):
        super().__init__(name="scene-fifo", daemon=True)
        self.path, self.data = path, memoryview(np.ascontiguousarray(data)).cast("B")
        self.halt = threading.Event()

    def run(self) -> None:
        fd = os.open(self.path, os.O_WRONLY)  # waits for the device's reader
        os.set_blocking(fd, False)
        try:  # a larger pipe: fewer wake-ups of this thread
            fcntl.fcntl(fd, fcntl.F_SETPIPE_SZ, 1 << 20)
        except OSError:
            pass
        poll = select.poll()  # not select(): the App's sockets take the low descriptors
        poll.register(fd, select.POLLOUT)
        pos, n = 0, len(self.data)
        try:
            while not self.halt.is_set():
                if not poll.poll(50):
                    continue
                try:
                    pos = (pos + os.write(fd, self.data[pos : min(n, pos + (1 << 20))])) % n
                except BlockingIOError:
                    continue
        except BrokenPipeError:
            pass
        finally:
            os.close(fd)

    def stop(self) -> None:
        self.halt.set()
        if self.is_alive():
            # a writer still waiting in open() is released by a reader
            fd = os.open(self.path, os.O_RDONLY | os.O_NONBLOCK)
            self.join(timeout=10.0)
            os.close(fd)


def config_text(cfg: dict, fifo: str) -> str:
    from benchmark.reference.channel import channel_frequencies, channel_spec

    app = cfg["app"]
    fullscale = f' fullscale = {float(cfg["fullscale"])!r};' if cfg.get("fullscale") is not None else ""
    chans = []
    for i, f in enumerate(channel_frequencies(cfg)):
        spec = channel_spec(cfg, i)
        keys = "".join(f" {CONFIG_KEYS[k]} = {v!r};".replace("'", '"') for k, v in vars(spec).items()
                       if k in CONFIG_KEYS and v not in (0, 0.0, None))
        chans.append(f'{{ freq = {int(f)};{keys} outputs: ( {{ type = "udp_stream"; dest_address = "127.0.0.1"; '
                     f'dest_port = {app["udp_base_port"] + i}; }} ); }}')
    return (
        f"fft_size = {cfg['fft_size']};\nwave_rate = {cfg['wave_rate']};\n"
        f"blocks_per_dispatch = {app['blocks_per_dispatch']};\nactive_fetch_slots = {app['active_fetch_slots']};\n"
        f'fetch_audio_fmt = "{app["fetch_audio_fmt"]}";\n'
        f"suppress_fade_tails = {str(app['suppress_fade_tails']).lower()};\n"
        f"fetch_meta_per_chunk = {str(app['fetch_meta_per_chunk']).lower()};\n"
        f'devices: ( {{ type = "file"; filepath = "{fifo}"; centerfreq = {cfg["center_freq"]}; '
        f'sample_rate = {cfg["sample_rate"]}; sample_format = "{cfg["sample_format"]}";{fullscale} speedup_factor = 0.0; '
        f'channels: ( {", ".join(chans)} ); }} );\n'
    )


def run(ctx) -> None:
    import torch

    from rtlsdr_airband_tpu_torch.app import App
    from rtlsdr_airband_tpu_torch.runtime.config import load_config

    from benchmark.capture import BlockTap, case

    cfg = ctx.config
    n_ch = cfg["channels"]["count"]
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = n_ch + 1024 if hard == resource.RLIM_INFINITY else min(hard, n_ch + 1024)
    if soft != resource.RLIM_INFINITY and soft < want:
        resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))

    scene = ctx.scene()
    data, W = scene.host, scene.W
    ctx.mark("scene")
    with tempfile.TemporaryDirectory(prefix="bench_app_") as tmp:
        fifo = os.path.join(tmp, f"scene.c{cfg['sample_format']}")  # named by format, as captures are: cu8, cs8, cs16, cf32
        os.mkfifo(fifo)
        conf = os.path.join(tmp, "cell.conf")
        with open(conf, "w") as f:
            f.write(config_text(cfg, fifo))
        app = App(load_config(conf), device=ctx.device.type)
        ctx.mark("program")
        rt = app.devices[0]
        p = rt.pipeline
        chunk = max(1, int(p.cfg.chunk_blocks))
        p.warm()
        ctx.mark("warm")

        users = ctx.sample_channels(scene, ctx.workload["check"]["channels"])
        dev_idx = np.argsort(p._order)[users]
        target = ctx.draw_block(chunk, int(ctx.seconds * 4))
        tap = BlockTap({0, target}, chunk)
        got = {}  # block -> what the sampled channels' sinks received

        def recording(b: int) -> None:
            got[b] = dict(sent=np.zeros(len(users), bool), audio=np.zeros((p.W, len(users)), np.float32))

        for b in (0, target):
            recording(b)
        cur = [-1]
        for j, u in enumerate(users):
            sink = rt.channels[u].outputs.udps[0]

            def record(left, right=None, _w=sink.write, _j=j):
                if cur[0] in got:
                    got[cur[0]]["sent"][_j] = True
                    got[cur[0]]["audio"][:, _j] = left
                _w(left, right)

            sink.write = record

        from rtlsdr_airband_tpu_torch.runtime import pipeline as pipeline_mod

        chains: list[tuple[float, int, object, object]] = []  # (host start, blocks, start event, end event)
        chain = pipeline_mod.pipeline_chain

        def timed_chain(*a, **k):
            if not ctx.on_card:
                return chain(*a, **k)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            e0.record()  # on the current stream: the pipeline's own, inside its dispatch
            out = chain(*a, **k)
            e1.record()
            chains.append((t, int(k["k_blocks"]), e0, e1))
            return out

        pipeline_mod.pipeline_chain = timed_chain
        if ctx.trace:
            ctx.spans.wrap(p, "_dispatch", "dispatch")
            ctx.spans.wrap_generator(p, "_to_host", "rebuild")
            event_sync = torch.cuda.Event.synchronize
            ctx.spans.wrap(torch.cuda.Event, "synchronize", "copy_wait")

        stamps: list[float] = []
        overflowed: list[int] = []
        state = dict(end=None, last=None)
        handle = app._handle_block

        def handled(r, out):
            b = len(stamps)
            t0 = time.perf_counter()
            closing = (ctx.window_start is not None and state["end"] is None and (b + 1) % chunk == 0
                       and t0 - ctx.window_start >= ctx.seconds)
            if closing:
                recording(b)
            cur[0] = b
            handle(r, out)
            t1 = time.perf_counter()
            ctx.spans.add("handler", t0, t1)
            stamps.append(t1)
            overflowed.append(int(out.get("gather_overflow", 0)))
            if b == chunk - 1:
                ctx.begin_window(t1)
            elif closing:
                state["end"], state["last"] = t1, b
                ctx.spans.on = False

        app._handle_block = handled
        writer = FifoWriter(fifo, data)
        writer.start()
        ctx.start_profiler()
        try:
            app.start()
            deadline = time.perf_counter() + ctx.seconds + 240.0
            while time.perf_counter() < deadline:
                if state["end"] is not None and len(stamps) > target:
                    break
                if not any(r.alive for r in app.devices):
                    raise RuntimeError("the App's input stopped")
                if not app._service_once():
                    time.sleep(0.001)
            if ctx.on_card:
                torch.cuda.synchronize()
        finally:
            writer.stop()
            app.stop()
            pipeline_mod.pipeline_chain = chain
            tap.close()
            if ctx.trace:
                torch.cuda.Event.synchronize = event_sync
        if state["end"] is None:
            raise RuntimeError(f"the window did not close: {len(stamps)} blocks handled")
        ctx.end_window(state["end"])

    first, last = chunk, state["last"]
    n = last - first + 1
    ctx.e2e["setup_s"] = ctx.window_start - ctx.t_start
    ctx.e2e["realtime_x"] = n * W / cfg["wave_rate"] / (state["end"] - ctx.window_start)
    timed = [c for c in chains if ctx.window_start <= c[0] <= state["end"]]
    if timed:
        blocks = sum(k for _, k, _, _ in timed)
        ctx.e2e["card_ms.app"] = sum(e0.elapsed_time(e1) for _, _, e0, e1 in timed) / blocks
        tr = ctx.trace_result
        if tr is not None and tr.found and len(timed) > 1:  # the trace's busy time from the first chunk's dispatch to the last's
            ctx.counters.update(card_busy_ms=tr.busy_between(timed[0][0], timed[-1][0]) / (blocks - timed[-1][1]) * 1e3)
    mid = first + (n // chunk // 2) * chunk - 1  # a chunk's end halfway through the window
    ctx.counters.update(realtime_x_halves=[(mid - first + 1) * W / cfg["wave_rate"] / (stamps[mid] - ctx.window_start),
                                           (last - mid) * W / cfg["wave_rate"] / (stamps[last] - stamps[mid])])
    ctx.attempted = ctx.blocks_in_window = n
    # the file device's reader waits while the ring is full, so a full ring
    # loses nothing; blocks whose open channels overflowed the slots lose audio
    ctx.failed = sum(1 for b in range(first, last + 1) if overflowed[b] > 0)
    ctx.counters.update(ring_full_waits=int(rt.input.ring.overflow_count), opened=sum(int(st.squelch_open_count > 0) for ch in rt.channels for st in ch.stats),
                        d2h_bytes_per_block=p.fetched_bytes / max(1, p.blocks_processed), checked_blocks=sorted({0, target, last}))
    if last not in tap.kept:
        raise RuntimeError(f"the tap no longer holds the window's last block {last}")
    ctx.cases = [case(tap, b, users, dev_idx, scene, got[b]) for b in sorted({0, target, last})]
