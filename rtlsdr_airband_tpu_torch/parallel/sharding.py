"""Multi-device sharding of the channelizer + demod pipeline.

Counterpart of ``rtlsdr_airband_tpu/parallel/sharding.py``.  The
reference's only parallelism is pthreads in one process (SURVEY.md §2.5);
here one device's channel population is laid out on a 2-D grid of torch
devices with axes ('time', 'chan'):

 - 'time': the channelizer's frames are independent over time except for
   the window overlap.  Time shard t takes body samples [t·body/T,
   (t+1)·body/T) and needs the next shard's first fft_size-hop samples as
   its halo (the last shard's halo is the block's tail, the stream
   look-ahead the framer appended): overlap-save channelization, the halo
   exchanged between neighbours.  Each time shard runs the four float32
   GEMMs at M = W/T rows on the first cell of its row.
 - 'chan': everything after the channelizer is per-channel recurrence,
   sharded over channels with no communication at all.  The time-sharded
   channelizer output is resharded to channel shards by one all-to-all, and
   the demod (K1 on the card) runs once per channel shard, on that cell's
   device.

A channel shard holds the same contiguous block of channels as JAX's
``P(None, axes)`` with ``axes = pick_channel_axes(mesh, C)``, so "the
channels this cell holds" is the same set in both packages.  A sharded
pytree (``shard_last``) is a list with one tree per channel shard; leaves
without a channel dim (the sin/cos LUTs) are replicated onto every shard's
device.  ``replicate`` gives one copy per mesh cell.

A mesh may list a device more than once: ``["cpu"] * 8`` is the CPU tests'
counterpart of the JAX suite's 8 virtual CPU devices, and ``[cuda:0] * 4``
runs the sharded code on one card.  On the card every cell has its own
compute stream.

The collective steps (the halo exchange, the reshard, the gather of
per-channel outputs, the tail broadcast) go through the mesh's transport:
``InProcess`` (here) moves tensors between the cells' devices and streams;
``multihost.Distributed`` runs them over torch.distributed.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass

import torch

from ..ops.channelizer import channelize_matmul, decode_raw_iq

# leaves laid out [..., C, 2] (an IQ pair a channel): channels on the second-last axis
PAIR_LEAVES = frozenset({"iq_tail"})


def copy_to(x: torch.Tensor, device: torch.device, src_stream, dst_stream) -> torch.Tensor:
    """A copy of ``x`` (made on ``src_stream``) on ``device``, ready for use
    on ``dst_stream``; streams are None on the CPU.  The copy is queued on
    the producer's stream, behind the work that made ``x``, and the consumer
    waits on an event recorded after it: no host wait.  The copy is marked
    as used on the consumer's stream, so the allocator cannot hand its
    memory out again before the consumer is done."""
    if src_stream is None and dst_stream is None:
        return x.to(device, copy=True)
    if src_stream is None:
        with torch.cuda.stream(dst_stream):
            return x.to(device, copy=True)
    with torch.cuda.stream(src_stream):
        y = x.to(device, copy=True, non_blocking=True)
        done = torch.cuda.Event()
        done.record(src_stream)
    if dst_stream is None:  # to the host: the copy must have landed
        done.synchronize()
        return y
    dst_stream.wait_event(done)
    y.record_stream(dst_stream)
    return y


def current_stream(device):
    """The calling thread's current stream of ``device`` (None on the CPU)."""
    return torch.cuda.current_stream(device) if device is not None and device.type == "cuda" else None


@dataclass
class ChannelShards:
    """A dense per-channel output left with the shards that computed it (a
    multi-process mesh): ``parts[j]`` [..., Cb] holds the device-order
    channels ``slices[j]`` of channel shard j, None where another process
    holds it."""

    parts: list
    slices: list


class InProcess:
    """Every cell in this process: the collective steps are copies between
    the cells' devices (``copy_to``), each cell on its own stream."""

    cell_streams = True
    gathers_dense = True  # one host drains every channel: dense outputs are gathered

    def is_local(self, cell: int) -> bool:
        return True

    def exchange(self, mesh, items: list) -> list:
        """Point-to-point moves: ``items`` are (tensor, src_cell, dst_cell,
        shape, dtype); returns the tensors on their destination cells."""
        return [copy_to(x, mesh.device(dst), mesh.stream(src), mesh.stream(dst)) for x, src, dst, _, _ in items]

    halo = reshard = exchange

    def gather(self, mesh, parts: list, layout: list, dim: int) -> torch.Tensor:
        """The channel shards ``parts`` (per layout entry) concatenated along
        ``dim`` on the home cell, for use on the caller's current stream."""
        home = mesh.device(mesh.home)
        dst = current_stream(home)
        return torch.cat([copy_to(p, home, mesh.stream(cell), dst) for p, (cell, _) in zip(parts, layout)], dim=dim)


class PipelineMesh:
    """A ('time', 'chan') grid of torch devices: ``devices[t][c]``,
    ``shape == {"time": T, "chan": Cc}``, ``size == T * Cc``.  Cells are
    numbered row-major (cell ``t * Cc + c``).  ``devices`` may repeat a
    device; in a multi-process mesh a cell another process holds is None.
    On the card each cell has its own compute stream (``stream``) when the
    transport runs the cells on streams of their own."""

    def __init__(self, devices, transport=None):
        self.devices = [[torch.device(d) if d is not None else None for d in row] for row in devices]
        T, Cc = len(self.devices), len(self.devices[0])
        if any(len(row) != Cc for row in self.devices):
            raise ValueError("mesh rows differ in length")
        self.shape = {"time": T, "chan": Cc}
        self.size = T * Cc
        self.transport = transport if transport is not None else InProcess()
        self.cells = [d for row in self.devices for d in row]
        self._streams = [
            torch.cuda.Stream(d) if self.transport.cell_streams and d is not None and d.type == "cuda" else None
            for d in self.cells
        ]
        self.home = next(i for i, d in enumerate(self.cells) if d is not None and self.transport.is_local(i))

    def __repr__(self) -> str:
        return f"PipelineMesh({self.shape}, {[str(d) for d in self.cells]})"

    def with_own_streams(self) -> "PipelineMesh":
        """The same cells and transport, with compute streams of its own (a
        Pipeline takes one, so pipelines fed from several threads never
        share a stream)."""
        return PipelineMesh(self.devices, self.transport)

    def device(self, cell: int) -> torch.device:
        return self.cells[cell]

    def stream(self, cell: int):
        """The cell's compute stream (the caller's current stream of its
        device if it has none; None on the CPU)."""
        s = self._streams[cell]
        return s if s is not None else current_stream(self.cells[cell])

    def on(self, cell: int):
        """Context of the cell's device operations: its stream on the card."""
        s = self._streams[cell]
        return torch.cuda.stream(s) if s is not None else contextlib.nullcontext()

    def time_cell(self, t: int) -> int:
        """The cell that runs time shard ``t``: the first of row ``t``."""
        return t * self.shape["chan"]

    def is_local(self, cell: int) -> bool:
        return self.transport.is_local(cell)

    @contextlib.contextmanager
    def scope(self):
        """Around one block program: every cell stream first waits for the
        caller's current stream of its device (inputs made there are ready),
        and afterwards the caller's streams wait for the cells (outputs and
        frees on the caller's stream come after the cells' work)."""
        pairs = [(s, torch.cuda.current_stream(d)) for s, d in zip(self._streams, self.cells) if s is not None]
        for s, cur in pairs:
            s.wait_stream(cur)
        yield
        for s, cur in pairs:
            cur.wait_stream(s)


def make_pipeline_mesh(devices=None, time_shards: int | None = None, transport=None) -> PipelineMesh:
    """Mesh with ('time', 'chan') axes over the given devices (default:
    every CUDA device).  ``time_shards`` defaults, as in the JAX package, to
    2 when there are at least 4 devices and an even count, else 1."""
    devices = list(devices) if devices is not None else [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = len(devices)
    if n == 0:
        raise ValueError("make_pipeline_mesh: no devices")
    if time_shards is None:
        time_shards = 2 if n >= 4 and n % 2 == 0 else 1
    if n % time_shards:
        raise ValueError(f"{n} devices do not divide into {time_shards} time shards")
    cc = n // time_shards
    return PipelineMesh([devices[t * cc : (t + 1) * cc] for t in range(time_shards)], transport)


def pick_channel_axes(mesh: PipelineMesh, C: int) -> tuple:
    """Mesh axes to shard the per-channel demod state over.  Channels spread
    over EVERY device when C divides the device count (the demod stage has
    zero cross-channel communication, so the time-axis devices shouldn't
    idle through it); smaller channel populations fall back to one axis, and
    indivisible ones (e.g. a single scan channel) replicate — correctness
    first, the channelizer stays time-sharded either way."""
    t, c = mesh.shape["time"], mesh.shape["chan"]
    if C % (t * c) == 0:
        return ("time", "chan")
    if C % c == 0:
        return ("chan",)
    if C % t == 0:
        return ("time",)
    return ()


def channel_layout(mesh: PipelineMesh, C: int) -> list[tuple[int, slice]]:
    """(cell, channel slice) of every channel shard: the contiguous blocks of
    JAX's ``P(None, pick_channel_axes(mesh, C))``.  A block that JAX
    replicates over an axis is held once, by the first cell that holds it."""
    T, Cc = mesh.shape["time"], mesh.shape["chan"]
    cells = {
        ("time", "chan"): range(T * Cc),
        ("chan",): range(Cc),
        ("time",): range(0, T * Cc, Cc),
        (): range(1),
    }[pick_channel_axes(mesh, C)]
    b = C // len(cells)
    return [(cell, slice(j * b, (j + 1) * b)) for j, cell in enumerate(cells)]


def channel_axis(shape: tuple, channel_dim: int, pair: bool = False) -> int | None:
    """The axis holding a leaf's channels: the last, or the second last for
    an IQ-pair leaf [..., C, 2]; None when it has not ``channel_dim``
    entries (a leaf shared by every channel, e.g. the sin/cos LUTs)."""
    ax = len(shape) - (2 if pair else 1)
    return ax if ax >= 0 and shape[ax] == channel_dim else None


def map_leaves(fn, tree, name: str = ""):
    """``fn(leaf, name)`` over a pytree of NamedTuples, lists and tuples of
    tensors (None stays None); ``name`` is the leaf's field name."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(fn, v, f) for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, name) for v in tree)
    return fn(tree, name)


def _leaves(tree) -> list:
    out = []
    map_leaves(lambda leaf, _: out.append(leaf), tree)
    return out


def infer_channel_dim(tree) -> int:
    """The most common last-dim size across the tree's leaves."""
    return Counter(leaf.shape[-1] for leaf in _leaves(tree) if leaf.dim() > 0).most_common(1)[0][0]


def _cell_copy(mesh: PipelineMesh, x: torch.Tensor, cell: int) -> torch.Tensor:
    """``x`` (on the caller's current stream) copied onto ``cell``."""
    return copy_to(x, mesh.device(cell), current_stream(x.device), mesh.stream(cell))


def shard_last(mesh: PipelineMesh, tree, channel_dim: int | None = None) -> list:
    """One copy of ``tree`` per channel shard (``channel_layout``), each cut
    to the shard's channels along every leaf's channel axis and placed on
    the shard's cell; leaves without a channel dim are replicated.  Shards
    another process holds are None.  ``channel_dim`` defaults to the most
    common last-dim size across leaves."""
    if channel_dim is None:
        channel_dim = infer_channel_dim(tree)

    def cut(cell, sl):
        def leaf(x, name):
            ax = channel_axis(tuple(x.shape), channel_dim, name in PAIR_LEAVES)
            return _cell_copy(mesh, x if ax is None else x.narrow(ax, sl.start, sl.stop - sl.start), cell)

        return map_leaves(leaf, tree)

    return [cut(cell, sl) if mesh.is_local(cell) else None for cell, sl in channel_layout(mesh, channel_dim)]


def replicate(mesh: PipelineMesh, tree) -> list:
    """One copy of ``tree`` per mesh cell, on the cell's device (None where
    another process holds the cell)."""
    return [map_leaves(lambda x, _: _cell_copy(mesh, x, cell), tree) if mesh.is_local(cell) else None for cell in range(mesh.size)]


def gather_last(mesh: PipelineMesh, shards: list):
    """The inverse of :func:`shard_last` in one process: the shards'
    leaves concatenated along their channel axis on the home cell
    (replicated leaves from the first shard)."""
    if any(s is None for s in shards):
        raise ValueError("gather_last: a shard is held by another process")
    cb = infer_channel_dim(shards[0])
    C = cb * len(shards)
    layout = channel_layout(mesh, C)
    flat = [_leaves(s) for s in shards]
    it = iter(range(len(flat[0])))

    def leaf(x, name):
        i = next(it)
        ax = channel_axis(tuple(x.shape), cb, name in PAIR_LEAVES)
        if ax is None:
            return copy_to(x, mesh.device(mesh.home), mesh.stream(layout[0][0]), current_stream(mesh.device(mesh.home)))
        return mesh.transport.gather(mesh, [f[i] for f in flat], layout, ax)

    return map_leaves(leaf, shards[0])


def on_cell(mesh: PipelineMesh, x, cell: int):
    """A block input for ``cell``: its entry of a per-cell list
    (``replicate``), else a copy of the tensor (or tuple of tensors, as the
    taps) onto the cell."""
    if isinstance(x, list):
        return x[cell]
    return map_leaves(lambda t, _: _cell_copy(mesh, t, cell), x)


def split_block(mesh: PipelineMesh, x: torch.Tensor, *, hop: int, n_frames: int):
    """A whole block of IQ pairs [body + halo, 2] as the mesh program takes
    it: (body slices per time shard, each on its time shard's cell, the
    tail [halo, 2])."""
    T = mesh.shape["time"]
    lb = n_frames * hop // T
    parts = [_cell_copy(mesh, x[t * lb : (t + 1) * lb], mesh.time_cell(t)) if mesh.is_local(mesh.time_cell(t)) else None
             for t in range(T)]
    return parts, x[T * lb :]


def time_sharded_rows(
    mesh: PipelineMesh,
    x_body: list,
    x_tail,
    bins,
    window,
    *,
    hop: int,
    fft_size: int,
    n_frames: int,
    taps=None,
    sample_fmt: str = "pairs",
    fullscale: float = 1.0,
):
    """Overlap-save channelizer over the 'time' axis.  Per time shard t
    (None where another process runs it): (mags [W/T, C], iqs [W/T, C, 2],
    the shard's input [body/T + halo, 2]) on cell (t, 0).

    ``x_body[t]`` is shard t's slice of the block body (IQ pairs, or raw
    samples when ``sample_fmt`` is set, decoded on the shard's device);
    ``x_tail`` [fft_size - hop, 2] the block's tail in pairs.  Each shard
    sends its first fft_size - hop samples to its left neighbour, which
    needs them as its trailing halo (the reference duplicates a ring
    buffer's tail for the same purpose, input-helpers.cpp:27-54); the last
    shard takes the tail.  ``bins``/``window``/``taps`` are tensors or
    per-cell lists (``replicate``)."""
    T = mesh.shape["time"]
    if n_frames % T:
        raise ValueError(f"{n_frames} frames do not divide into {T} time shards")
    local_frames = n_frames // T
    halo = fft_size - hop
    if local_frames * hop < halo:
        raise ValueError(f"a time shard's {local_frames * hop} samples are fewer than its {halo}-sample halo")
    cells = [mesh.time_cell(t) for t in range(T)]
    local = [mesh.is_local(c) for c in cells]
    xb = [None] * T
    for t in range(T):
        if local[t]:
            with mesh.on(cells[t]):
                xb[t] = x_body[t] if sample_fmt == "pairs" else decode_raw_iq(x_body[t], sample_fmt, fullscale)
    heads = [(xb[t + 1][:halo] if local[t + 1] else None, cells[t + 1], cells[t], (halo, 2), torch.float32) for t in range(T - 1)]
    halos = mesh.transport.halo(mesh, heads) + [on_cell(mesh, x_tail, cells[-1]) if local[-1] else None]
    out = [None] * T
    for t in range(T):
        if not local[t]:
            continue
        with mesh.on(cells[t]):
            xloc = torch.cat([xb[t], halos[t]], dim=0)
            tp = on_cell(mesh, taps, cells[t]) if taps is not None else None
            m, z = channelize_matmul(xloc, on_cell(mesh, bins, cells[t]), on_cell(mesh, window, cells[t]),
                                     hop=hop, fft_size=fft_size, n_frames=local_frames, taps=tp)
            out[t] = (m, z, xloc)
    return out


def reshard_rows(mesh: PipelineMesh, rows: list, layout: list, n_frames: int) -> list:
    """The all-to-all from time shards to channel shards: for every channel
    shard (layout entry) on its cell, (mags [W, Cb], iqs [W, Cb, 2]), the
    time shards' rows of its channels in time order (None where another
    process holds the shard)."""
    T = mesh.shape["time"]
    lw = n_frames // T
    items = []
    for t in range(T):
        src = mesh.time_cell(t)
        for cell, sl in layout:
            cb = sl.stop - sl.start
            for which in (0, 1):
                x = rows[t][which][:, sl] if rows[t] is not None else None
                items.append((x, src, cell, (lw, cb) if which == 0 else (lw, cb, 2), torch.float32))
    moved = mesh.transport.reshard(mesh, items)
    out = []
    for j, (cell, _) in enumerate(layout):
        if not mesh.is_local(cell):
            out.append(None)
            continue
        pieces = [moved[2 * (t * len(layout) + j) : 2 * (t * len(layout) + j) + 2] for t in range(T)]
        with mesh.on(cell):
            out.append((torch.cat([p[0] for p in pieces]), torch.cat([p[1] for p in pieces])))
    return out


def channelize_time_sharded_parts(mesh: PipelineMesh, x_body: list, x_tail, bins, window, *, hop: int, fft_size: int,
                                  n_frames: int, taps=None):
    """The time-sharded channelizer's output per time shard: lists of mags
    [W/T, C] and iqs [W/T, C, 2] on each time shard's cell (None where
    another process runs the shard).  Arguments as :func:`time_sharded_rows`."""
    with mesh.scope():
        rows = time_sharded_rows(mesh, x_body, x_tail, bins, window, hop=hop, fft_size=fft_size, n_frames=n_frames, taps=taps)
    return [r[0] if r is not None else None for r in rows], [r[1] if r is not None else None for r in rows]


def channelize_time_sharded(mesh: PipelineMesh, x: torch.Tensor, bins, window, *, hop: int, fft_size: int, n_frames: int):
    """Whole-block wrapper: ``x`` is [n_frames*hop + (fft_size-hop), 2] with
    the global halo appended; returns (mags [W, C], iqs [W, C, 2]), the time
    shards' rows concatenated on the home cell (one process only)."""
    body, tail = split_block(mesh, x, hop=hop, n_frames=n_frames)
    mags, iqs = channelize_time_sharded_parts(mesh, body, tail, bins, window, hop=hop, fft_size=fft_size, n_frames=n_frames)
    home = mesh.device(mesh.home)
    cells = [mesh.time_cell(t) for t in range(len(mags))]
    cat = lambda parts: torch.cat([copy_to(p, home, mesh.stream(c), current_stream(home)) for p, c in zip(parts, cells)])  # noqa: E731
    return cat(mags), cat(iqs)


def make_sharded_pipeline_step(
    mesh: PipelineMesh,
    *,
    hop: int,
    fft_size: int,
    n_frames: int,
    fm_quadri: bool = False,
    with_ctcss: bool = True,
    demod_backend: str = "cuda",
):
    """The multi-device block step: time-sharded overlap-save channelizer ->
    all-to-all reshard -> the demod once per channel shard.  A thin wrapper
    over ``runtime.pipeline.pipeline_block`` with ``mesh`` set, so every
    parity test of this step exercises the code the mesh-mode Pipeline
    dispatches.

    ``step(x, bins, window, params, state) -> (state, audio, iq_out,
    active)``: ``x`` is a whole block [body + halo, 2] or the (body slices,
    tail) pair of ``multihost.make_global_input``; ``params``/``state`` are
    sharded (``shard_last``), the returned state too.  In one process
    ``audio``/``iq_out`` are [W, C] / [W, C, 2] on the home cell; across
    processes they stay with the shards (``multihost.local_audio_shards``).
    ``active`` [C] is replicated."""
    from ..runtime.pipeline import pipeline_block

    def step(x, bins, window, params, state):
        if isinstance(x, torch.Tensor):
            x = split_block(mesh, x, hop=hop, n_frames=n_frames)
        state, out = pipeline_block(
            x, bins, window, params, state, hop=hop, fft_size=fft_size, n_frames=n_frames,
            fm_quadri=fm_quadri, with_ctcss=with_ctcss, demod_backend=demod_backend, mesh=mesh,
        )
        return state, out["audio"], out["iq_out"], out["active"]

    return step
