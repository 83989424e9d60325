"""Application orchestrator: config -> inputs -> pipelines -> outputs.

Counterpart of ``rtlsdr_airband_tpu/app.py``.  The analog of the
reference's main() wiring + thread topology (reference:
src/rtl_airband.cpp:701-1164): instead of demod/output/mixer threads
synchronized by condvars, each device runs an input driver thread feeding a
ring buffer, and the single app loop drains every device's ring into its
``Pipeline`` at block cadence (on the card: the demod kernel K1 once a
block), fanning each block's audio out to the per-channel output sets,
mixers, stats, scan controllers and AFC trackers.

``App(cfg, device=...)`` chooses where every pipeline runs: ``"cuda"`` (the
default; without a card ``Pipeline`` raises) or ``"cpu"`` for the plain
PyTorch versions, which the tests choose explicitly.  There is no automatic
fallback.  ``mesh_devices = N > 1`` spreads each device's channels over a
('time', 'chan') mesh of the first N distinct GPUs (``N`` CPU cells with
``device="cpu"``).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .constants import AGC_EXTRA
from .inputs.base import Input, InputState, input_new, make_ring_buffer
from .logutil import LOG_INFO, LOG_NOTICE, LOG_WARNING, debug_print, log
from .ops.levels import level_to_dbfs
from .outputs.dispatch import OutputSet, TagQueue
from .outputs.filemgr import FileOutput
from .outputs.icecast import IcecastOutput
from .outputs.pulse import make_pulse_output
from .outputs.stats import DeviceStats, FreqStats, MixerStats, StatsWriter
from .outputs.udp import UdpStreamOutput
from .parallel.sharding import make_pipeline_mesh
from .runtime import trace
from .runtime.config import DeviceConfig, GlobalConfig, OutputConfig, pipeline_backend
from .runtime.control import AFCTracker, ScanController
from .runtime.mixer import Mixer
from .runtime.pipeline import Pipeline, PipelineConfig

OUTPUT_CHECK_PERIOD_SEC = 10.0  # reference: output_check_thread (output.cpp:936)
SINK_QUEUE_DEPTH = 4  # blocks buffered per sink worker before overrun
RING_BLOCKS = 4  # blocks a device's ring holds at least, where its keys ask for less


class SinkWorker:
    """Per-device/per-mixer host output thread (reference:
    multiple_output_threads, rtl_airband.cpp:817-819, 1056-1090).

    One worker owns all sinks of one device (or mixer): the block loop
    submits fan-out jobs and keeps running, so a slow LAME/file/Icecast sink
    can never stall another device's block cadence.  A full queue counts an
    output overrun and drops the oldest block — the analog of the reference's
    waveavail-still-set overwrite (rtl_airband.cpp:649-655)."""

    def __init__(self, name: str, depth: int = SINK_QUEUE_DEPTH):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.overrun_count = 0
        self._t = threading.Thread(target=self._loop, daemon=True, name=f"sink-{name}")
        self._t.start()

    def submit(self, jobs: list) -> bool:
        """jobs: list of (callable, args, kwargs) to run in order."""
        try:
            self.q.put_nowait(jobs)
            return True
        except queue.Full:
            self.overrun_count += 1
            try:
                self.q.get_nowait()  # drop the oldest queued block
            except queue.Empty:
                pass
            try:
                self.q.put_nowait(jobs)
            except queue.Full:
                pass
            return False

    def submit_aux(self, jobs: list) -> bool:
        """Best-effort housekeeping job (e.g. reconnect): dropped when the
        queue is full, without counting an audio overrun."""
        try:
            self.q.put_nowait(jobs)
            return True
        except queue.Full:
            return False

    def _loop(self) -> None:
        while True:
            jobs = self.q.get()
            if jobs is None:
                return
            for fn, args, kwargs in jobs:
                try:
                    fn(*args, **kwargs)
                except Exception as e:  # a broken sink must not kill the worker
                    log(LOG_WARNING, f"sink worker: {type(e).__name__}: {e}")

    def close(self, timeout: float = 10.0) -> None:
        """Drain queued blocks, then stop the thread.  If a sink job has
        wedged permanently (the failure the worker isolates), drop the queued
        blocks so the sentinel always fits — close() must never hang the
        app's shutdown on a dead sink."""
        try:
            self.q.put(None, timeout=timeout)
        except queue.Full:
            try:
                while True:
                    self.q.get_nowait()
            except queue.Empty:
                pass
            try:
                self.q.put_nowait(None)
            except queue.Full:
                pass
        self._t.join(timeout=timeout)


class DemodWorker(threading.Thread):
    """Per-device demod thread (reference: multiple_demod_threads spawns one
    demodulate() thread per SDR device, rtl_airband.cpp:809-816,1052-1090):
    runs one device's ring-drain -> pipeline-dispatch -> block-handling loop
    so device A's host fetch overlaps device B's device compute.  Mixer and
    sink state touched from here is lock-guarded (runtime/mixer.py) or
    per-device (stats, scan controllers, the pipeline itself)."""

    def __init__(self, app: "App", rt: "DeviceRuntime"):
        super().__init__(daemon=True, name=f"demod-{rt.stats.index}")
        self.app, self.rt = app, rt

    def run(self) -> None:
        while not self.app.do_exit and self.rt.alive:
            try:
                worked = self.app._service_device(self.rt)
            except Exception as e:  # a broken device must not kill the app
                log(LOG_WARNING, f"demod worker {self.rt.stats.index}: {type(e).__name__}: {e}")
                self.rt.alive = False
                # same cleanup the InputState.FAILED branch performs: drain
                # the pipeline tail and disable the channel's mixer feeds, so
                # downstream mixes don't wait out the late-input deadline on
                # a dead device (reference: rtl_airband.cpp:377-391)
                self.app._drain_and_disable(self.rt)
                break
            if not worked:
                time.sleep(0.005)


def _build_output_set(outputs: list[OutputConfig], wave_rate: int, mixers: dict[str, Mixer], highpass: int, lowpass: int, stereo: bool = False, use_localtime: bool = False) -> OutputSet:
    need_mp3 = any(o.type == "icecast" for o in outputs)
    oset = OutputSet(wave_rate, stereo=stereo, need_mp3=need_mp3, highpass=highpass, lowpass=lowpass)
    for o in outputs:
        if not o.enabled:
            continue
        if o.type == "icecast":
            ice = IcecastOutput(
                o.server, o.port, o.mountpoint, o.username, o.password,
                name=o.name, genre=o.genre, description=o.description,
                send_scan_freq_tags=o.send_scan_freq_tags, tls=o.tls,
            )
            oset.icecasts.append(ice)
        elif o.type in ("file", "rawfile"):
            fo = FileOutput(
                basedir=o.directory,
                basename=o.filename_template,
                wave_rate=wave_rate,
                encoder_kind="auto" if o.type == "file" else "raw",
                stereo=stereo,
                continuous=o.continuous,
                append=o.append,
                split_on_transmission=o.split_on_transmission,
                include_freq=o.include_freq,
                dated_subdirectories=o.dated_subdirectories,
                use_localtime=use_localtime,
                is_iq=o.type == "rawfile",
            )
            (oset.iq_files if o.type == "rawfile" else oset.files).append(fo)
        elif o.type == "udp_stream":
            oset.udps.append(UdpStreamOutput(o.dest_address, o.dest_port, stereo=stereo))
        elif o.type == "pulse":
            p = make_pulse_output(wave_rate, stereo=stereo, sink=o.sink or None, stream_name=o.stream_name or "rtlsdr-airband-tpu")
            if p.available:
                oset.pulses.append(p)
            else:
                log(LOG_WARNING, "pulse output unavailable (libpulse-simple not found) — dropping")
        elif o.type == "mixer":
            m = mixers.get(o.name)
            if m is None:
                raise ValueError(f"mixer {o.name!r} not defined")
            idx = m.connect_input(o.ampfactor, o.balance)
            oset.mixer_feeds.append((m, idx))
    return oset


@dataclass
class ChannelRuntime:
    spec_source: object  # ChannelConfig
    outputs: OutputSet
    freq_idx: int = 0
    afc: AFCTracker | None = None
    stats: FreqStats | None = None
    last_open: bool = False


@dataclass
class DeviceRuntime:
    cfg: DeviceConfig
    input: Input
    pipeline: Pipeline
    channels: list[ChannelRuntime]
    scan: ScanController | None = None
    stats: DeviceStats | None = None
    alive: bool = True
    bytes_per_block: int = 0
    _prime_need: int = 0
    indicators: list[str] = field(default_factory=list)
    sink_worker: SinkWorker | None = None
    # vectorized block handling (devices without scan/AFC): per-channel
    # python work scales O(open + idle-tick channels), not O(C) — at 8192
    # channels the naive loop's host time is a large share of the 125 ms
    # realtime budget
    fast_path: bool = False
    economy: object | None = None  # FetchEconomy (cfg.fetch_economy = auto)
    econ_overflow_seen: int = 0  # gather_overflow_count at last observation
    freq0: np.ndarray | None = None  # [C] frequency of freqs[0]
    idle_tick_idx: np.ndarray | None = None  # channels needing closed-squelch process()
    activity_accum: np.ndarray | None = None  # [C] open-block counter
    block_meta: dict | None = None  # last block's meta arrays (lazy stats)
    zero_block: np.ndarray | None = None  # shared [W] silence buffer
    zero_iq: np.ndarray | None = None  # shared [W] complex64 silence buffer
    iq_idle_set: frozenset = frozenset()  # channels with continuous iq_files


class App:
    def __init__(self, cfg: GlobalConfig, fm_quadri: bool = False, tui: bool = False, clock=time.time, device: str = "cuda"):
        with trace.span("setup.app", always=True):
            self.cfg = cfg
            self.tui = tui
            self._clock = clock
            self.device = device
            self.wave_rate = cfg.resolved_wave_rate()
            self.do_exit = False
            self._last_output_check = 0.0

            # multi-device mesh, shared by every device's pipeline (reference
            # analog: multiple_demod_threads spreads SDR devices over CPU
            # threads, rtl_airband.cpp:1052-1090; here one device's channel
            # population spans GPUs through a ('time', 'chan') mesh)
            self.mesh = None
            if cfg.mesh_devices > 1:
                self.mesh = make_pipeline_mesh(self._mesh_devices(cfg.mesh_devices), time_shards=cfg.mesh_time_shards or None)
                log(LOG_NOTICE, f"multi-device mesh: {dict(self.mesh.shape)} over {cfg.mesh_devices} {torch.device(device).type} device(s)")
            self.demod_backend = pipeline_backend(cfg.demod_backend)

            # mixers first (reference: parse_mixers before parse_devices)
            self.mixers: dict[str, Mixer] = {}
            self.mixer_outputs: dict[str, OutputSet] = {}
            wave_batch = self.wave_rate // 8
            for name, mcfg in cfg.mixers.items():
                self.mixers[name] = Mixer(name, wave_batch, clock=clock)

            self.devices: list[DeviceRuntime] = []
            for di, d in enumerate(cfg.devices):
                if d.disable:
                    continue
                self.devices.append(self._build_device(di, d, fm_quadri))

            # mixer OUTPUT sets after the devices: connecting channel inputs is
            # what decides each mixer's mono/stereo mode (balance != 0 ->
            # stereo, reference: mixer.cpp:81-85), and the encoders/sinks need
            # the final mode at construction
            for name, mcfg in cfg.mixers.items():
                self.mixer_outputs[name] = _build_output_set(
                    mcfg.outputs, self.wave_rate, self.mixers, mcfg.highpass, mcfg.lowpass,
                    stereo=self.mixers[name].stereo, use_localtime=cfg.localtime,
                )

            # per-device + per-mixer host output threads (reference:
            # multiple_output_threads, rtl_airband.cpp:1056-1090)
            self.mixer_workers: dict[str, SinkWorker] = {}
            if cfg.multiple_output_threads:
                for rt in self.devices:
                    rt.sink_worker = SinkWorker(f"dev{rt.stats.index}")
                for name in self.mixers:
                    self.mixer_workers[name] = SinkWorker(f"mixer-{name}")

            self.stats_writer = StatsWriter(cfg.stats_filepath, cfg.fft_size, clock=clock) if cfg.stats_filepath else None
            self._demod_workers: list[DemodWorker] = []

    # ------------------------------------------------------------------ build

    def _mesh_devices(self, n: int) -> list:
        """The mesh's cells: the first ``n`` distinct GPUs on the card (a
        ValueError when fewer are present; a GPU is never repeated), or
        ``n`` CPU cells, the CPU tests' counterpart of virtual devices."""
        if torch.device(self.device).type == "cpu":
            return ["cpu"] * n
        have = torch.cuda.device_count()
        if have < n:
            raise ValueError(f"mesh_devices = {n} but only {have} GPU(s) present")
        return [torch.device("cuda", i) for i in range(n)]

    def _build_device(self, di: int, d: DeviceConfig, fm_quadri: bool) -> DeviceRuntime:
        scan_mode = d.mode == "scan"
        # scan mode: single channel, tune to freqs[0] with DC-dodge offset
        specs = []
        chrts = []
        dev_stats = DeviceStats(index=di)
        for ch in d.channels:
            spec = ch.spec_for(0)
            specs.append(spec)
            oset = _build_output_set(ch.outputs, self.wave_rate, self.mixers, ch.highpass, ch.lowpass, use_localtime=self.cfg.localtime)
            fstats = [
                FreqStats(frequency=f.frequency, label=f.label) for f in ch.freqs
            ]
            dev_stats.freqs.extend(fstats)
            chrts.append(ChannelRuntime(spec_source=ch, outputs=oset, stats=fstats))

        scan = None
        centerfreq = d.centerfreq
        if scan_mode:
            ch0 = d.channels[0]
            scan = ScanController(
                [f.frequency for f in ch0.freqs],
                [f.label for f in ch0.freqs],
                d.sample_rate,
                self.cfg.fft_size,
                clock=self._clock,
                log_scan_activity=self.cfg.log_scan_activity,
                logger=lambda m: log(LOG_INFO, m),
            )
            centerfreq = scan.center_for(ch0.freqs[0].frequency)

        # scan/AFC devices run fully synchronous single-block dispatch
        # (chunk 1, async_depth 0): their control loops feed back per block
        # at the reference's 200 ms cadence, and an in-flight block from the
        # OLD tuning draining after a retune would be misattributed to the
        # NEW frequency (the reference hops synchronously,
        # rtl_airband.cpp:112-123).  Other devices chain blocks_per_dispatch
        # blocks per dispatch with one chunk in flight so the host fetch
        # overlaps device compute.
        control_device = scan_mode or any(ch.afc for ch in d.channels)
        chunk = 1 if control_device else self.cfg.blocks_per_dispatch
        pcfg = PipelineConfig(
            sample_rate=d.sample_rate,
            center_freq=centerfreq,
            fft_size=self.cfg.fft_size,
            wave_rate=self.wave_rate,
            sample_format=d.sample_format,
            fullscale=d.fullscale if d.fullscale is not None else {"u8": 127.5, "s8": 127.5, "s16": 32768.0, "f32": 1.0}.get(d.sample_format, 1.0),
            fm_quadri=fm_quadri,
            chunk_blocks=chunk,
            async_depth=0 if control_device else 1,
            active_slots=self.cfg.active_fetch_slots,
            fetch_audio_i16=self.cfg.fetch_audio_i16,
            fetch_audio_fmt=self.cfg.fetch_audio_fmt,
            suppress_fade_tails=self.cfg.suppress_fade_tails,
            fetch_meta_per_chunk=self.cfg.fetch_meta_per_chunk,
            demod_backend=self.demod_backend,
            device=self.device,
            mesh=self.mesh,
        )
        with trace.span("setup.pipeline", always=True):
            pipeline = Pipeline(pcfg, specs)

        for ci, (ch, chrt) in enumerate(zip(d.channels, chrts)):
            if ch.afc:
                chrt.afc = AFCTracker(base_bin=int(pipeline.base_bins[ci]), afc=ch.afc, fft_size=self.cfg.fft_size)

        with trace.span("setup.input", always=True):
            if d.type == "file":
                inp = input_new(
                    "file",
                    filepath=d.filepath,
                    sample_rate=d.sample_rate,
                    centerfreq=centerfreq,
                    sample_format=d.sample_format,
                    speedup_factor=d.speedup_factor,
                    fullscale=d.fullscale,
                )
            else:
                kwargs = dict(sample_rate=d.sample_rate, centerfreq=centerfreq, gain=d.gain, correction=d.correction)
                if d.serial:
                    kwargs["serial"] = d.serial
                elif d.type in ("rtlsdr", "mirisdr"):
                    kwargs["index"] = d.index
                if d.type == "rtlsdr" and d.buffers > 0:
                    # reference: buffers * default buflen (input-rtlsdr.cpp:215-221)
                    from .inputs.rtlsdr import DEFAULT_BUFLEN

                    kwargs["buf_size"] = d.buffers * DEFAULT_BUFLEN
                if d.type == "mirisdr" and d.num_buffers > 0:
                    # reference: num_buffers libusb buffers of 320 kB
                    # (input-mirisdr.cpp:200-206, default bufcnt 10)
                    kwargs["buf_size"] = d.num_buffers * 320_000
                if d.type == "soapysdr":
                    kwargs["device_string"] = d.device_string
                    kwargs["channel"] = d.channel
                    if d.antenna:
                        kwargs["antenna"] = d.antenna
                    # hardware AGC is implied by omitting gain
                    # (input-soapysdr.cpp:157-172)
                    kwargs["agc"] = d.gain is None
                inp = input_new(d.type, **kwargs)

        rt = DeviceRuntime(cfg=d, input=inp, pipeline=pipeline, channels=chrts, scan=scan, stats=dev_stats)
        rt.bytes_per_block = pipeline._block_need * inp.bytes_per_sample
        # the service loop reads a whole block from the ring: a wideband
        # device's block (5 MB at 20 Msps in s8) outgrows the 3.2 MB default
        if inp.ring.size < RING_BLOCKS * rt.bytes_per_block:
            inp.ring = make_ring_buffer(RING_BLOCKS * rt.bytes_per_block, inp.ring.extra)
        if inp.ring.size < rt.bytes_per_block:
            raise ValueError(
                f"device {di}: its ring holds {inp.ring.size} B, less than one block of {rt.bytes_per_block} B"
            )
        rt.indicators = [" "] * len(chrts)

        # vectorized fast path for control-free devices: sinks that still
        # need a closed-squelch call each block are exactly the ones the
        # reference's process_outputs touches when squelch is closed —
        # icecast (streams encoded silence), continuous-mode files, and
        # mixer inputs (deadline accounting needs the silence batch)
        rt.fast_path = scan is None and not any(ch.afc for ch in d.channels)
        if rt.fast_path:
            rt.freq0 = np.array([c.spec_source.freqs[0].frequency for c in chrts], np.int64)
            idle = [
                ci
                for ci, c in enumerate(chrts)
                if c.outputs.icecasts
                or c.outputs.mixer_feeds
                or any(fo.continuous for fo in c.outputs.files)
                or any(fo.continuous for fo in c.outputs.iq_files)
            ]
            rt.idle_tick_idx = np.array(idle, np.int64)
            rt.activity_accum = np.zeros(len(chrts), np.int64)
            rt.zero_block = np.zeros(self.wave_rate // 8, np.float32)
            # continuous IQ file sinks write zeroed IQ while squelch is
            # closed (the slow path passes the dense iq column and
            # OutputSet.process zeroes it, dispatch.py:107-110; the fast
            # path must pass SOME iq buffer or process() skips iq_files)
            rt.zero_iq = np.zeros(self.wave_rate // 8, np.complex64)
            rt.iq_idle_set = frozenset(
                ci for ci, c in enumerate(chrts) if any(fo.continuous for fo in c.outputs.iq_files)
            )
        # adaptive fetch economy (reference analog: graceful, visible load
        # management via overrun counters, rtl_airband.cpp:649-655; here the
        # transport itself drifts so the knobs must move): only meaningful
        # for gather-mode control-free devices
        if self.cfg.fetch_economy == "auto" and pcfg.active_slots > 0 and rt.fast_path:
            from .runtime.economy import FetchEconomy, default_ladder

            ladder = default_ladder(pcfg.active_slots, pcfg.audio_fmt)
            start = next(i for i, r in enumerate(ladder) if r.slots == pcfg.active_slots and r.fmt == pcfg.audio_fmt)
            rt.economy = FetchEconomy(ladder, start, block_budget_ms=1000.0 * (self.wave_rate // 8) / self.wave_rate)
            log(LOG_NOTICE, f"device {di}: fetch economy ladder {[str(r) for r in ladder]}, start {ladder[start]}")
        return rt

    # -------------------------------------------------------------------- run

    def start(self, gate_timeout: float = 5.0) -> None:
        for rt in self.devices:
            rt.input.init()
            rt.input.start()
        # all-devices-up gate (reference: rtl_airband.cpp:1024-1032 — wait
        # up to 5 s for every input to reach RUNNING; count_devices_running
        # counts only INPUT_RUNNING, so any hardware device that FAILS inside
        # the window is fatal, immediately).  STOPPED (and, for file inputs
        # only, FAILED — EOF drives the file driver to FAILED per
        # input-file.cpp:104-108) counts as "came up": an unpaced file input
        # may legitimately finish its whole stream inside the gate window.
        def up(rt):
            ok = (InputState.RUNNING, InputState.STOPPED)
            if rt.cfg.type == "file":
                ok = ok + (InputState.FAILED,)
            return rt.input.state in ok

        def hard_failed(rt):
            return rt.cfg.type != "file" and rt.input.state == InputState.FAILED

        deadline = time.monotonic() + gate_timeout
        while time.monotonic() < deadline:
            if any(hard_failed(rt) for rt in self.devices):
                break
            if all(up(rt) for rt in self.devices):
                break
            time.sleep(0.1)
        n_down = sum(0 if up(rt) else 1 for rt in self.devices)
        if n_down:
            log(LOG_WARNING, f"{n_down} device(s) failed to initialize - aborting")
            raise RuntimeError(f"{n_down} device(s) failed to initialize")
        # pre-warm the fetch-economy neighbor rungs in the background (the
        # port's rungs share one kernel library: this builds it if it is not
        # loaded yet, so the first shift does not stall on nvcc)
        for rt in self.devices:
            if rt.economy is not None:
                for i in rt.economy.neighbors():
                    n = rt.economy.rungs[i]
                    rt.pipeline.warm_async(slots=n.slots, fmt=n.fmt)
        if self.cfg.multiple_demod_threads and len(self.devices) > 1:
            self._demod_workers = [DemodWorker(self, rt) for rt in self.devices]
            for w in self._demod_workers:
                w.start()
            log(LOG_NOTICE, f"multiple_demod_threads: {len(self._demod_workers)} per-device demod worker(s)")
        log(LOG_NOTICE, f"started {len(self.devices)} device(s), wave_rate={self.wave_rate}")

    def stop(self) -> None:
        self.do_exit = True
        # join demod workers fully before touching their pipelines: a worker
        # still blocked inside pipeline.feed (e.g. a first dispatch waiting
        # on the kernel library's build) must not race the main thread
        # on _pending/_inflight/state (reference: the ordered join-everything
        # shutdown, rtl_airband.cpp:1114-1158)
        for w in self._demod_workers:
            while w.is_alive():
                w.join(timeout=30.0)
                if w.is_alive():
                    log(LOG_NOTICE, f"waiting for demod worker {w.rt.stats.index} (in-flight dispatch/compile)")
        self._demod_workers = []
        for rt in self.devices:
            rt.input.stop()
        # drain in-flight pipeline chunks so no dispatched audio is dropped
        for rt in self.devices:
            if rt.alive:
                for out in rt.pipeline.flush():
                    self._handle_block(rt, out)
        # drain the device sink workers FIRST (their queues may still hold
        # mixer put_samples jobs from the final chunks), then mix once more
        # with force so a partially-gathered batch isn't dropped, then drain
        # the mixer output workers
        for rt in self.devices:
            if rt.sink_worker is not None:
                rt.sink_worker.close()
                rt.stats.output_overrun_count = rt.sink_worker.overrun_count
        self._service_mixers(force=True)
        for w in self.mixer_workers.values():
            w.close()
        for rt in self.devices:
            for chrt in rt.channels:
                chrt.outputs.close()
        for name, oset in self.mixer_outputs.items():
            oset.close()
        # final fold of fast-path meta arrays into the per-freq stats objects
        # (callers read them after stop() even without a stats file)
        self._sync_all_stats()
        if self.stats_writer is not None:
            self.stats_writer.write(
                [rt.stats for rt in self.devices],
                [MixerStats(name=n, output_overrun_count=m.output_overrun_count, input_overrun_counts=[i.overrun_count for i in m.inputs]) for n, m in self.mixers.items()],
            )
        # join any background kernel-build threads so interpreter exit never
        # races them (reference: rtl_airband.cpp:1114-1158 joins everything)
        for rt in self.devices:
            rt.pipeline.close()
        log(LOG_NOTICE, "shutdown complete")

    def _drain_and_disable(self, rt: DeviceRuntime) -> None:
        """Failure cleanup shared by the InputState.FAILED branch and the
        DemodWorker exception path: drain the pipeline's in-flight tail,
        then disable the device's mixer feeds."""
        try:
            for out in rt.pipeline.flush():
                self._handle_block(rt, out)
        except Exception as e:  # the drain itself may hit the broken device
            log(LOG_WARNING, f"device {rt.stats.index}: drain failed: {type(e).__name__}: {e}")
        for chrt in rt.channels:
            for m, idx in chrt.outputs.mixer_feeds:
                m.disable_input(idx)

    def run(self, max_seconds: float | None = None) -> None:
        """Main loop: drain inputs, process blocks, service mixers/outputs.
        Exits when all inputs die (reference: rtl_airband.cpp:377-391) or
        ``do_exit`` is set (signal handlers)."""
        self.start()
        t_start = self._clock()
        try:
            while not self.do_exit:
                worked = self._service_once()
                if max_seconds is not None and self._clock() - t_start > max_seconds:
                    break
                if not any(rt.alive for rt in self.devices):
                    log(LOG_NOTICE, "all devices failed/stopped — exiting")
                    break
                if not worked:
                    time.sleep(0.005)
        finally:
            self.stop()

    def _service_device(self, rt: DeviceRuntime) -> bool:
        """One service pass for one device: drain its ring into its pipeline,
        handle completed blocks.  Runs on the main loop, or on the device's
        own DemodWorker thread when multiple_demod_threads is set."""
        if not rt.alive:
            return False
        if rt.input.state == InputState.FAILED and rt.input.available_bytes() < rt.bytes_per_block:
            # device dead: feed the sub-block ring remainder (the stream
            # tail — e.g. the final halo of a file input), drain the
            # pipeline, then disable its outputs
            # (reference: rtl_airband.cpp:377-391)
            rt.alive = False
            remainder = rt.input.available_bytes()
            if remainder:
                tail = rt.input.read_bytes(remainder)
                if tail is not None:
                    for out in rt.pipeline.feed(tail):
                        self._handle_block(rt, out)
            log(LOG_NOTICE, f"device {rt.stats.index}: input failed — disabling outputs")
            self._drain_and_disable(rt)
            return False
        # ring overflow counter -> device stats (reference: the rx
        # callback's overflow detection feeding buffer_overflow_count,
        # input-helpers.cpp:56-61 / output.cpp:787-800)
        rt.stats.buffer_overflow_count = int(rt.input.ring.overflow_count)
        rt.stats.gather_overflow_count = int(rt.pipeline.gather_overflow_count)
        if rt.input.available_bytes() < rt.bytes_per_block:
            return False
        with trace.span("app.service"):
            with trace.span("app.ring_read"):
                raw = rt.input.read_bytes(rt.bytes_per_block)
            t0 = time.perf_counter()
            n_blocks = 0
            for out in rt.pipeline.feed(raw):
                self._handle_block(rt, out)
                n_blocks += 1
            if n_blocks:
                elapsed_ms = (time.perf_counter() - t0) * 1e3
                # loop-latency debug trace (reference: rtl_airband.cpp:656-661)
                debug_print(f"device {rt.stats.index}: {n_blocks} block(s) in {elapsed_ms:.2f} ms")
                if rt.economy is not None:
                    self._observe_economy(rt, elapsed_ms / n_blocks)
        return True

    def _observe_economy(self, rt: DeviceRuntime, ms_per_block: float) -> None:
        econ = rt.economy
        ov = int(rt.pipeline.gather_overflow_count)
        delta = ov - rt.econ_overflow_seen
        rt.econ_overflow_seen = ov
        if econ.observe(ms_per_block, delta) is None:
            return
        r = econ.rung
        log(
            LOG_NOTICE,
            f"device {rt.stats.index}: fetch economy shift -> {r} "
            f"(ema {econ.ema_ms:.0f} ms/block, budget {econ.budget:.0f}, overflow +{delta})",
        )
        rt.pipeline.apply_rung(r.slots, r.fmt)
        for i in econ.neighbors():
            n = econ.rungs[i]
            rt.pipeline.warm_async(slots=n.slots, fmt=n.fmt)

    def _service_once(self) -> bool:
        worked = False
        if not self._demod_workers:
            with trace.span("app.round"):
                serviced = sum(self._service_device(rt) for rt in self.devices)
                trace.count("app.devices_serviced", serviced)
            worked = serviced > 0
        self._service_mixers()
        self._service_outputs_check()
        if self.tui and self._demod_workers:
            self._draw_tui()
        if self.stats_writer is not None and self.stats_writer.due():
            self._sync_all_stats()
            self.stats_writer.maybe_write(
                [rt.stats for rt in self.devices],
                [MixerStats(name=n, output_overrun_count=m.output_overrun_count, input_overrun_counts=[i.overrun_count for i in m.inputs]) for n, m in self.mixers.items()],
            )
        return worked

    # ---------------------------------------------------------------- blocks

    def _handle_block(self, rt: DeviceRuntime, out: dict) -> None:
        with trace.span("app.handler", rt.pipeline.last_yielded):
            if rt.fast_path:
                self._handle_block_fast(rt, out)
            else:
                self._handle_block_slow(rt, out)

    def _handle_block_slow(self, rt: DeviceRuntime, out: dict) -> None:
        """Per-channel block handling: stats, sinks, AFC and scan control."""
        audio = np.asarray(out["audio"])  # [W, C]
        active = np.asarray(out["active"])  # [C]
        signal_level = np.asarray(out["signal_level"])
        noise_level = np.asarray(out["noise_level"])
        squelch_level = np.asarray(out["squelch_level"])
        sig_outside = np.asarray(out["sig_outside"])
        open_counts = np.asarray(out["open_count"])
        flappy_counts = np.asarray(out["flappy_count"])
        ctcss_found = np.asarray(out["ctcss_found"])
        ctcss_not_found = np.asarray(out["ctcss_not_found"])
        iq_out = None
        if "iq_out" in out:
            pairs = np.asarray(out["iq_out"])  # [W, C, 2] f32
            iq_out = (pairs[..., 0] + 1j * pairs[..., 1]).astype(np.complex64)
        spectrum = np.asarray(out["spectrum_power"]) if "spectrum_power" in out else None

        scan_freq_changed = None
        new_bins = None
        sink_jobs: list = []
        trace.count("app.open_channels", int(np.count_nonzero(active)))
        with trace.span("app.sinks", rt.pipeline.last_yielded):
            for ci, chrt in enumerate(rt.channels):
                is_open = bool(active[ci])
                fs = chrt.stats[chrt.freq_idx]
                fs.noise_level = float(noise_level[ci])
                fs.signal_level = float(signal_level[ci])
                fs.squelch_level = float(squelch_level[ci])
                fs.squelch_open_count = int(open_counts[ci])
                fs.flappy_count = int(flappy_counts[ci])
                fs.ctcss_count = int(ctcss_found[ci])
                fs.no_ctcss_count = int(ctcss_not_found[ci])
                if is_open:
                    fs.activity_count += 1

                # scan-mode metadata tag (channel 0 of scan devices)
                scan_tag = None
                if rt.scan is not None and ci == 0:
                    q = rt.scan.tag_queue
                    idx = q.get(self.cfg.shout_metadata_delay)
                    if idx is not None:
                        f = rt.scan.st.freqs[idx]
                        label = rt.scan.st.labels[idx]
                        scan_tag = f"{f / 1e6:.3f} MHz" + (f" {label}" if label else "")
                        q.advance()

                kwargs = dict(
                    iq=iq_out[:, ci] if iq_out is not None else None,
                    has_signal=is_open,
                    frequency=chrt.spec_source.freqs[chrt.freq_idx].frequency,
                    scan_tag=scan_tag,
                )
                if rt.sink_worker is not None:
                    # copy: the job runs async on the sink thread, and the
                    # pipeline reuses its dense audio buffer between blocks
                    sink_jobs.append((chrt.outputs.process, (np.array(audio[:, ci]),), kwargs))
                else:
                    chrt.outputs.process(audio[:, ci], **kwargs)

                if chrt.afc is not None:
                    b = chrt.afc.finalize(is_open, spectrum)
                    if new_bins is None:
                        new_bins = np.array(rt.pipeline.base_bins)
                    new_bins[ci] = b
                    rt.indicators[ci] = chrt.afc.indicator
                else:
                    rt.indicators[ci] = "*" if is_open else " "
                # '~' (signal outside filter) takes precedence over the state
                # glyph (reference: rtl_airband.cpp:633)
                if bool(sig_outside[ci]):
                    rt.indicators[ci] = "~"
                chrt.last_open = is_open

            if rt.sink_worker is not None:
                rt.sink_worker.submit(sink_jobs)
                rt.stats.output_overrun_count = rt.sink_worker.overrun_count

        if new_bins is not None and not np.array_equal(new_bins, rt.pipeline.user_bins):
            rt.pipeline.set_bins(new_bins)

        if rt.scan is not None:
            new_center = rt.scan.tick(bool(active[0]))
            if new_center is not None:
                scan_freq_changed = new_center
        if scan_freq_changed is not None:
            self._retune_scan(rt, scan_freq_changed)

        if self.tui and not self._demod_workers:
            self._draw_tui()  # with demod workers the main loop redraws

    def _handle_block_fast(self, rt: DeviceRuntime, out: dict) -> None:
        """O(open + idle-tick) block handling for control-free devices.

        The naive per-channel loop's host time at 8192 channels is a large
        share of the 125 ms realtime budget, almost all of it per-channel
        python for CLOSED channels whose sinks do nothing.
        Here the per-block python touches only open channels and the
        precomputed idle-tick set; meta arrays are kept on the runtime and
        folded into the per-freq stats objects lazily at stats-write/TUI
        cadence (:meth:`_sync_stats`).  Semantics vs the slow path are
        identical for devices without scan/AFC (asserted equal in
        tests/test_torch_app_udp.py::test_fast_path_matches_slow_path)."""
        audio = np.asarray(out["audio"])  # [W, C]
        active = np.asarray(out["active"])  # [C]
        rt.block_meta = out
        rt.activity_accum += active

        iq_out = None
        if "iq_out" in out:
            pairs = np.asarray(out["iq_out"])  # [W, C, 2] f32
            iq_out = (pairs[..., 0] + 1j * pairs[..., 1]).astype(np.complex64)

        sink_jobs: list = []
        open_idx = np.flatnonzero(active)
        trace.count("app.open_channels", len(open_idx))
        # one batched gather instead of per-channel strided column reads:
        # sinks serialize the audio (tobytes/encode), and a non-contiguous
        # [W] column copy per open channel costs more than the whole rest
        # of the fast path at a few hundred open channels
        with trace.span("app.gather", rt.pipeline.last_yielded):
            open_audio = np.ascontiguousarray(audio[:, open_idx].T)  # [n_open, W]
        with trace.span("app.sinks", rt.pipeline.last_yielded):
            for j, ci in enumerate(open_idx):
                chrt = rt.channels[ci]
                kwargs = dict(
                    iq=iq_out[:, ci] if iq_out is not None else None,
                    has_signal=True,
                    frequency=int(rt.freq0[ci]),
                )
                if rt.sink_worker is not None:
                    sink_jobs.append((chrt.outputs.process, (open_audio[j],), kwargs))
                else:
                    chrt.outputs.process(open_audio[j], **kwargs)
            for ci in rt.idle_tick_idx:
                if active[ci]:
                    continue
                chrt = rt.channels[ci]
                kwargs = dict(has_signal=False, frequency=int(rt.freq0[ci]))
                if ci in rt.iq_idle_set:
                    kwargs["iq"] = rt.zero_iq
                if rt.sink_worker is not None:
                    sink_jobs.append((chrt.outputs.process, (rt.zero_block,), kwargs))
                else:
                    chrt.outputs.process(rt.zero_block, **kwargs)

            if rt.sink_worker is not None:
                rt.sink_worker.submit(sink_jobs)
                rt.stats.output_overrun_count = rt.sink_worker.overrun_count

        sig_outside = np.asarray(out["sig_outside"])
        rt.indicators = np.where(sig_outside, "~", np.where(active, "*", " ")).tolist()
        if self.tui and not self._demod_workers:
            self._draw_tui()

    def _sync_stats(self, rt: DeviceRuntime) -> None:
        """Fold the last block's meta arrays into the per-freq stats objects
        (fast-path devices defer this from per-block to stats/TUI cadence)."""
        m = rt.block_meta
        if m is None:
            return
        nl = np.asarray(m["noise_level"]).tolist()
        sl = np.asarray(m["signal_level"]).tolist()
        ql = np.asarray(m["squelch_level"]).tolist()
        oc = np.asarray(m["open_count"]).tolist()
        fc = np.asarray(m["flappy_count"]).tolist()
        cf = np.asarray(m["ctcss_found"]).tolist()
        cn = np.asarray(m["ctcss_not_found"]).tolist()
        act = rt.activity_accum.tolist()
        for ci, chrt in enumerate(rt.channels):
            fs = chrt.stats[0]  # fast-path devices never leave freq_idx 0
            fs.noise_level = nl[ci]
            fs.signal_level = sl[ci]
            fs.squelch_level = ql[ci]
            fs.squelch_open_count = oc[ci]
            fs.flappy_count = fc[ci]
            fs.ctcss_count = cf[ci]
            fs.no_ctcss_count = cn[ci]
            fs.activity_count = act[ci]

    def _sync_all_stats(self) -> None:
        for rt in self.devices:
            if rt.fast_path:
                self._sync_stats(rt)

    def _retune_scan(self, rt: DeviceRuntime, new_center: int) -> None:
        """reference: controller_thread hop (rtl_airband.cpp:112-123)."""
        debug_print(f"device {rt.stats.index}: scan retune center -> {new_center / 1e6:.4f} MHz")
        sc = rt.scan
        ch0 = rt.channels[0]
        ch0.freq_idx = sc.st.freq_idx
        specs = [c.spec_source.spec_for(c.freq_idx if i == 0 else 0) for i, c in enumerate(rt.channels)]
        rt.input.set_centerfreq(new_center)
        rt.pipeline.retune(specs, center_freq=new_center)

    # ---------------------------------------------------------- housekeeping

    def _service_mixers(self, force: bool = False) -> None:
        for name, m in self.mixers.items():
            out = m.poll(force=force)
            if out is None:
                continue
            oset = self.mixer_outputs[name]
            worker = self.mixer_workers.get(name)
            if m.stereo:
                args, kwargs = (out[:, 0],), dict(audio_r=out[:, 1], has_signal=getattr(m, "has_signal", True))
            else:
                args, kwargs = (out,), dict(has_signal=getattr(m, "has_signal", True))
            if worker is not None:
                worker.submit([(oset.process, args, kwargs)])
            else:
                oset.process(*args, **kwargs)
            m.output_consumed()

    def _service_outputs_check(self) -> None:
        now = self._clock()
        if now - self._last_output_check < OUTPUT_CHECK_PERIOD_SEC:
            return
        self._last_output_check = now
        # route reconnects through the sink workers when enabled so each
        # Icecast socket is only ever touched from one thread
        for rt in self.devices:
            for chrt in rt.channels:
                if rt.sink_worker is not None:
                    rt.sink_worker.submit_aux([(chrt.outputs.check_reconnect, (), {})])
                else:
                    chrt.outputs.check_reconnect()
        for name, oset in self.mixer_outputs.items():
            w = self.mixer_workers.get(name)
            if w is not None:
                w.submit_aux([(oset.check_reconnect, (), {})])
            else:
                oset.check_reconnect()

    # -------------------------------------------------------------------- tui

    def _draw_tui(self) -> None:
        """ANSI status grid (reference: rtl_airband.cpp:632-643, 1033-1048)."""
        self._sync_all_stats()  # fast-path devices defer stats to draw/write cadence
        lines = ["\x1b[H\x1b[2J=== rtlsdr-airband-tpu ==="]
        for rt in self.devices:
            lines.append(f"device {rt.stats.index} [{rt.cfg.type}] center={rt.pipeline.cfg.center_freq / 1e6:.3f} MHz")
            for ci, chrt in enumerate(rt.channels):
                f = chrt.spec_source.freqs[chrt.freq_idx]
                fs = chrt.stats[chrt.freq_idx]
                sig = level_to_dbfs(max(fs.signal_level, 1e-30), self.cfg.fft_size)
                nf = level_to_dbfs(max(fs.noise_level, 1e-30), self.cfg.fft_size)
                lines.append(f"  {f.frequency / 1e6:9.4f} MHz [{rt.indicators[ci]}] sig {sig:7.1f} dBFS  noise {nf:7.1f} dBFS  {f.label or ''}")
        print("\n".join(lines), flush=True)
