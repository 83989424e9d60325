"""The harness: one run of one cell, as ``benchmark/run.py`` is asked for it.

It reads the cell's files by name (``workloads/<cell>.json``, the
configuration it names in ``configs/``, the entry in ``entries/``), gives the
entry a ``Context``, and turns what the entry measured into the result line:
the cell's end-to-end metrics (``--trace 0``) or per-layer metrics (``--trace
1``, each from its reader ``metrics/<name>.py``), the device, and the
comparison with the reference that decides ``correct``.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rtlsdr_airband_tpu")


def process_start() -> float:
    """``time.perf_counter()`` at the instant this process started (from
    /proc; where that cannot be read, now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A file of the benchmark as a module, by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The metrics of ``kind`` (end_to_end / per_layer) this cell reports."""
    e2e_of_cell = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e_of_cell:
            out.append(m)
    return out


class Spans:
    """Host spans from the benchmark's own wrappers: per name, the total
    seconds and the count, and each interval (perf_counter seconds) for
    naming the device's idle gaps."""

    def __init__(self):
        self.on = False
        self.total: dict[str, float] = {}
        self.count: dict[str, int] = {}
        self.intervals: list[tuple[float, float, str]] = []

    def add(self, name: str, t0: float, t1: float) -> None:
        if not self.on:
            return
        self.total[name] = self.total.get(name, 0.0) + (t1 - t0)
        self.count[name] = self.count.get(name, 0) + 1
        self.intervals.append((t0, t1, name))

    def wrap(self, obj, attr: str, name: str) -> None:
        """Time every call of ``obj.attr``."""
        fn = getattr(obj, attr)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.add(name, t0, time.perf_counter())

        setattr(obj, attr, timed)

    def wrap_generator(self, obj, attr: str, name: str) -> None:
        """Time ``obj.attr``'s generator while it runs, not while its
        consumer holds a yielded item."""
        fn = getattr(obj, attr)

        def timed(*a, **k):
            gen = fn(*a, **k)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(gen)
                except StopIteration:
                    self.add(name, t0, time.perf_counter())
                    return
                self.add(name, t0, time.perf_counter())
                yield item

        setattr(obj, attr, timed)


@dataclasses.dataclass
class Trace:
    """The device's timeline over the window, from torch.profiler."""

    window_s: float
    busy_s: float
    ops: dict  # kernel or copy name -> [device seconds, count]
    idle_by_host: dict  # what the host was doing -> idle seconds of the device
    found: bool  # whether the profiler saw any device operation
    events: list = dataclasses.field(default_factory=list)  # (start, end) device seconds, sorted
    offset: float = 0.0  # device clock - host clock

    def busy_between(self, h0: float, h1: float) -> float:
        """Seconds in which an operation ran on the device between the host
        instants ``h0`` and ``h1`` (perf_counter seconds)."""
        lo, hi = h0 + self.offset, h1 + self.offset
        busy, cur_end = 0.0, lo
        for s, e in self.events:
            s, e = max(s, cur_end), min(e, hi)
            if e > s:
                busy += e - s
                cur_end = e
        return busy


class Profile:
    """torch.profiler around a window, CUDA activity only.  A marker kernel
    launched right after the start ties the device's clock to the host's, so
    the device's idle gaps can be named by the host span that covers them.
    On the CPU (the tests' runs) it records CPU activity only, so the
    program's recorder records, and its trace has no device operation."""

    def __init__(self, device, spans: Spans):
        self.device = device
        self.spans = spans
        self.prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        if self.device.type != "cuda":
            self.prof = profile(activities=[ProfilerActivity.CPU])
            self.prof.start()
            return
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize(self.device)
        marker = torch.empty(1, device=self.device)
        self.t_marker = time.perf_counter()
        marker.fill_(0.0)
        torch.cuda.synchronize(self.device)

    def stop(self, t0: float, t1: float) -> Trace:
        """Stop, and reduce the device operations that ran inside the host
        window [t0, t1] (perf_counter seconds)."""
        import torch

        if self.device.type != "cuda":
            self.prof.stop()
            return Trace(t1 - t0, 0.0, {}, {}, False)
        torch.cuda.synchronize(self.device)
        self.prof.stop()
        events = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start = e.start_ns() * 1e-9
            events.append((start, start + e.duration_ns() * 1e-9, e.name()))
        if not events:
            return Trace(t1 - t0, 0.0, {}, {}, False)
        events.sort()
        offset = events[0][0] - self.t_marker  # device clock - host clock
        lo, hi = t0 + offset, t1 + offset
        ops: dict = {}
        busy = 0.0
        gaps = []
        cur_end = lo
        for s, e, name in events[1:]:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            o = ops.setdefault(name, [0.0, 0])
            o[0] += e - s
            o[1] += 1
            if s > cur_end:
                gaps.append((cur_end, s))
            if e > cur_end:
                busy += e - max(s, cur_end)
                cur_end = e
        if hi > cur_end:
            gaps.append((cur_end, hi))
        idle: dict[str, float] = {}
        spans = sorted(self.spans.intervals)
        starts = [a for a, _, _ in spans]
        for a, b in gaps:
            mid = (a + b) / 2 - offset
            label = "no_span"
            for s0, s1, name in reversed(spans[max(0, bisect.bisect_right(starts, mid) - 8) : bisect.bisect_right(starts, mid)]):
                if s0 <= mid <= s1:
                    label = name
                    break
            idle[label] = idle.get(label, 0.0) + (b - a)
        return Trace(t1 - t0, busy, ops, idle, True, [(s, e) for s, e, _ in events[1:]], offset)


class Context:
    """What an entry gets: the cell's files, the run's arguments, the device,
    the spans and the profiler, and where to put what it measured."""

    def __init__(self, cell: str, workload: dict, config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
                 t_start: float):
        self.cell = cell
        self.workload = workload
        self.config = config
        self.traffic = traffic  # the scene's parameters (scenes/<scene>.json)
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t_start = t_start
        self.spans = Spans()
        self.rng = np.random.default_rng([seed, 14])
        # filled by the entry
        self.window_start: float | None = None
        self.e2e: dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        self.blocks_in_window = 0
        self.counters: dict = {}
        self.cases: list[dict] = []
        self.memory_peak_bytes = 0
        self.trace_result: Trace | None = None
        self._profile: Profile | None = None
        self.setup_marks: dict[str, float] = {}

    def mark(self, name: str) -> None:
        """Note how far into the process a step of set-up ended."""
        self.setup_marks[name] = round(time.perf_counter() - self.t_start, 3)

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def scene(self):
        from .scene import make_scene

        return make_scene(self.config, self.traffic, self.seed, self.device)

    def start_profiler(self) -> None:
        """In a traced run, start the profiler (on the CPU, one of CPU
        activity).  Call it in set-up, while the device is idle: the window's
        trace is cut out of it later."""
        if self.trace:
            self._profile = Profile(self.device, self.spans)
            self._profile.start()

    def begin_window(self, t: float | None = None) -> float:
        """Start the measured window at ``t`` (perf_counter seconds; now by
        default): set-up ends here, and in a traced run the spans start."""
        self.spans.on = self.trace
        self.window_start = time.perf_counter() if t is None else t
        return self.window_start

    def end_window(self, t_end: float) -> None:
        """Close the window at ``t_end`` (the entry has synchronised)."""
        self.spans.on = False
        if self._profile is not None:
            self.trace_result = self._profile.stop(self.window_start, t_end)
            self._profile = None
        if self.on_card:
            import torch

            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def draw_block(self, lo: int, span: int) -> int:
        """A block index in [lo, lo + span), drawn from the seed among the
        blocks during which the carriers are keyed on, so the block the
        comparison follows carries open channels."""
        nb = int(self.traffic["segment_blocks"])
        first_on = math.ceil(float(self.traffic["key_on"]) * nb)
        keyed = [b for b in range(lo, lo + max(span, nb)) if b % nb >= first_on]
        return int(self.rng.choice(keyed))

    def sample_channels(self, scene, count: int) -> np.ndarray:
        """The channels the comparison reads, drawn from the seed: half of
        them within four FFT bins of a carrier, the rest from the whole
        population."""
        from .reference.channel import channel_frequencies

        freqs = channel_frequencies(self.config)
        bin_hz = self.config["sample_rate"] / self.config["fft_size"]
        near = np.flatnonzero(np.min(np.abs(freqs[:, None] - freqs[scene.hot][None, :]), axis=1) <= 4 * bin_hz)
        n_near = min(len(near), count // 2)
        pick = set(self.rng.choice(near, n_near, replace=False).tolist())
        rest = np.setdiff1d(np.arange(len(freqs)), np.fromiter(pick, np.int64))
        pick |= set(self.rng.choice(rest, count - n_near, replace=False).tolist())
        return np.array(sorted(pick), np.int64)


def device_info(ctx: Context, chips: int) -> dict:
    if ctx.on_card:
        import torch

        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device), "count": chips,
                "memory_peak_bytes": ctx.memory_peak_bytes}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if ctx.trace and ctx.trace_result is not None:
        info["busy_s"] = ctx.trace_result.busy_s
        info["window_s"] = ctx.trace_result.window_s
    return info


def breakdown(tr: Trace) -> dict:
    ops = sorted(((name, v[0]) for name, v in tr.ops.items()), key=lambda r: -r[1])[:10]
    gaps = sorted(tr.idle_by_host.items(), key=lambda r: -r[1])[:10]
    return {"device_ops": [[n[:200], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def cell_files(cell: str) -> tuple[dict, dict, dict]:
    """(workload, configuration, scene) of a cell, read by name."""
    workload = load_json(HERE / "workloads" / f"{cell}.json")
    return (workload, load_json(HERE / "configs" / f"{workload['config']}.json"),
            load_json(HERE / "scenes" / f"{workload['scene']}.json"))


def run_cell(args, *, files: tuple[dict, dict, dict] | None = None) -> int:
    """One run of one cell; returns the exit code.  Prints the result line
    last on stdout, and the compared numbers last on stderr.  The files are
    read by the cell's name; the tests hand in small ones instead."""
    t_start = process_start()
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(ROOT / ".bench_cache" / sub))
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"benchmark: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    workload, config, traffic = files if files is not None else cell_files(args.workload)

    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"benchmark: cell {args.workload} needs {chips} CUDA device(s); found {n}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device(args.device)

    from .check import compare_cases

    entry = load_module(HERE / "entries" / f"{workload['entry']}.py", f"benchmark_entry_{workload['entry']}")
    import rtlsdr_airband_tpu_torch  # noqa: F401  (the import's time is set-up's first mark)

    ctx = Context(args.workload, workload, config, traffic, args.seed, float(args.seconds), bool(args.trace), device, t_start)
    ctx.mark("imports")
    try:
        entry.run(ctx)
    finally:
        if ctx._profile is not None:  # an entry that failed inside its window
            ctx._profile.prof.stop()

    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules loaded that the benchmark may not load: {', '.join(bad)}", file=sys.stderr)
        return 3

    numbers = compare_cases(config, ctx.cases, workload["check"]["limits"])
    correct = all(v["value"] <= v["limit"] for v in numbers.values()) and ctx.attempted > 0 and ctx.failed == 0

    metrics = {}
    kind = "per_layer" if args.trace else "end_to_end"
    for m in cell_metrics(bench, args.workload, kind):
        if kind == "end_to_end":
            value = ctx.e2e.get(m["name"])
        else:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py", f"benchmark_metric_{m['name'].replace('.', '_')}")
            value = reader.read(ctx)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    result = {"correct": bool(correct), "attempted": int(ctx.attempted), "failed": int(ctx.failed),
              "metrics": metrics, "device": device_info(ctx, chips)}
    if args.trace and ctx.trace_result is not None:
        result["breakdown"] = breakdown(ctx.trace_result)
    result["checks"] = numbers
    if ctx.setup_marks:
        print("setup: " + json.dumps(ctx.setup_marks), file=sys.stderr)
    if ctx.counters:
        print("counters: " + json.dumps({k: v for k, v in ctx.counters.items()}), file=sys.stderr)
    for name, v in numbers.items():
        print(f"check {name} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
