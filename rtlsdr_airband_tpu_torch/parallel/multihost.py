"""Multi-process execution over torch.distributed.

Counterpart of ``rtlsdr_airband_tpu/parallel/multihost.py``.  The reference
is a single process (SURVEY.md §2.5); scaling past one process follows the
JAX package's multi-controller recipe on torch.distributed:

 - every process calls :func:`initialize` with the same coordinator
   address: NCCL between GPUs (one a process), gloo between CPU processes;
 - :func:`global_mesh` lays the ('time', 'chan') mesh over every process's
   cells, cell ``i`` held by process ``i // cells_per_process``;
 - each process ingests only ITS time slices of the IQ stream
   (:func:`host_input_range` says which raw samples) and passes them to
   :func:`make_global_input` / :func:`make_global_chain_input`; the block's
   tail is broadcast from the process that owns the stream end;
 - ``pipeline_block`` / ``pipeline_chain`` with the mesh exchange the halo
   (``batch_isend_irecv``), reshard the channelizer rows (``all_to_all``)
   and replicate ``active`` and the meta rows (``all_gather``); the dense
   audio stays with the shards, and each process drains the channels it
   holds (:func:`local_audio_shards`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .sharding import ChannelShards, PipelineMesh, make_pipeline_mesh


class Distributed:
    """The transport of a multi-process mesh: collectives over
    torch.distributed.  Every cell's work runs on its process's current
    stream (NCCL orders its collectives with it)."""

    cell_streams = False
    gathers_dense = False  # each process drains only the channels it holds

    def __init__(self, rank: int, world: int, devices: list):
        self.rank, self.world = rank, world
        self.devices = [torch.device(d) for d in devices]  # this process's cells
        self.comm = self.devices[0]  # where collective buffers live (a GPU for NCCL, the CPU for gloo)

    def owner(self, cell: int) -> int:
        return cell // len(self.devices)

    def is_local(self, cell: int) -> bool:
        return self.owner(cell) == self.rank

    def halo(self, mesh, items: list) -> list:
        """Point-to-point moves, (tensor or None, src_cell, dst_cell, shape,
        dtype) each, by ``batch_isend_irecv``; the tensors that land here."""
        out, ops = [None] * len(items), []
        for i, (x, src, dst, shape, dtype) in enumerate(items):
            mine_src, mine_dst = self.is_local(src), self.is_local(dst)
            if mine_src and mine_dst:
                out[i] = x.to(mesh.device(dst), copy=True)
            elif mine_src:
                ops.append(dist.P2POp(dist.isend, x.contiguous().to(self.comm), self.owner(dst), tag=i))
            elif mine_dst:
                out[i] = torch.empty(shape, dtype=dtype, device=self.comm)
                ops.append(dist.P2POp(dist.irecv, out[i], self.owner(src), tag=i))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [y.to(mesh.device(it[2])) if y is not None else None for y, it in zip(out, items)]

    def reshard(self, mesh, items: list) -> list:
        """The same moves (float32) by one ``all_to_all``: every process
        packs what it sends each process, in item order, into one buffer,
        padded to the largest such buffer (gloo takes equal sizes only)."""
        numel = [int(np.prod(it[3])) for it in items]
        sizes = np.zeros((self.world, self.world), np.int64)
        for n, (_, src, dst, _, _) in zip(numel, items):
            sizes[self.owner(src), self.owner(dst)] += n
        m = int(sizes.max())
        send = []
        for r in range(self.world):
            parts = [x.reshape(-1).to(self.comm) for (x, src, dst, _, _) in items if self.is_local(src) and self.owner(dst) == r]
            buf = torch.zeros(m, dtype=torch.float32, device=self.comm)
            if parts:
                flat = torch.cat(parts)
                buf[: flat.numel()] = flat
            send.append(buf)
        recv = [torch.empty(m, dtype=torch.float32, device=self.comm) for _ in range(self.world)]
        dist.all_to_all(recv, send)
        out, offset = [None] * len(items), [0] * self.world
        for i, (n, (_, src, dst, shape, _)) in enumerate(zip(numel, items)):
            if self.is_local(dst):
                r = self.owner(src)
                out[i] = recv[r][offset[r] : offset[r] + n].reshape(shape).to(mesh.device(dst))
                offset[r] += n
        return out

    def gather(self, mesh, parts: list, layout: list, dim: int) -> torch.Tensor:
        """The channel shards concatenated along ``dim``, on every process
        (``all_gather``): each process contributes its own shards, which the
        layout makes one contiguous block of channels of equal size."""
        cells = [cell for cell, _ in layout]
        if cells != list(range(mesh.size)):
            raise ValueError("a multi-process mesh needs a channel count divisible by its cell count")
        mine = [p for p, cell in zip(parts, cells) if self.is_local(cell)]
        local = torch.cat([p.to(self.comm) for p in mine], dim=dim)
        as_u8 = local.dtype == torch.bool  # collectives move bytes, not bools
        if as_u8:
            local = local.to(torch.uint8)
        got = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(got, local.contiguous())
        full = torch.cat(got, dim=dim)
        return full.to(torch.bool) if as_u8 else full

    def broadcast(self, mesh, x, src_cell: int, shape, dtype):
        """``x`` from the process holding ``src_cell`` to every process."""
        buf = x.to(self.comm).contiguous() if self.is_local(src_cell) else torch.empty(shape, dtype=dtype, device=self.comm)
        dist.broadcast(buf, src=self.owner(src_cell))
        return buf

    def close(self) -> None:
        """Leave the process group (after a barrier: no process tears down
        while another still talks to it)."""
        dist.barrier()
        dist.destroy_process_group()


def initialize(coordinator_address: str, num_processes: int, process_id: int, backend: str | None = None, *,
               device: str = "cuda", local_cells: int = 1) -> Distributed:
    """Join the process group (``tcp://coordinator_address``, every process
    the same) and return this process's transport.  ``device="cuda"``: NCCL,
    one GPU a process (``cuda:process_id`` modulo the GPUs present), which
    raises without a card; ``"cpu"``: gloo with ``local_cells`` CPU cells a
    process, the CPU tests' counterpart of virtual devices.  ``backend``
    overrides the choice."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost: no CUDA device; pass device='cpu' for gloo processes on the CPU")
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        devices = [dev] * local_cells
    elif device == "cpu":
        devices = [torch.device("cpu")] * local_cells
    else:
        raise ValueError(f"unknown device {device!r}")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id)
    return Distributed(process_id, num_processes, devices)


def global_mesh(transport: Distributed, time_shards: int | None = None) -> PipelineMesh:
    """('time', 'chan') mesh over every cell of every process; a cell of
    another process is None here."""
    n = len(transport.devices)
    cells = [transport.devices[i % n] if transport.is_local(i) else None for i in range(transport.world * n)]
    return make_pipeline_mesh(cells, time_shards=time_shards, transport=transport)


def host_input_range(mesh: PipelineMesh, *, n_frames: int, hop: int, fft_size: int) -> list[tuple[int, int, int]]:
    """Raw-IQ sample ranges this PROCESS must ingest, as
    ``(global_offset, body_len, halo_len)`` per time shard whose mesh row
    holds a cell of this process.  The sharded channelizer takes a block as
    [body | final halo] with the body split over the 'time' axis; a shard's
    look-ahead comes from the next shard (the halo exchange), so a process
    needs only its body slices, plus the tail where it owns the last
    shard."""
    T = mesh.shape["time"]
    if n_frames % T:
        raise ValueError(f"{n_frames} frames do not divide into {T} time shards")
    body = n_frames * hop
    local_body = body // T
    halo = fft_size - hop
    Cc = mesh.shape["chan"]
    return [(t * local_body, local_body, halo if t == T - 1 else 0)
            for t in range(T) if any(mesh.is_local(t * Cc + c) for c in range(Cc))]


def _body_parts(mesh: PipelineMesh, local: dict) -> list:
    """Time shard t's slice as a tensor on its cell where this process runs
    it, None elsewhere."""
    parts = []
    for t in range(mesh.shape["time"]):
        cell = mesh.time_cell(t)
        parts.append(torch.as_tensor(np.ascontiguousarray(local[t]), device=mesh.device(cell)) if mesh.is_local(cell) else None)
    return parts


def _tail(mesh: PipelineMesh, tail, shape) -> torch.Tensor:
    """The tail from the process that owns the stream end (the last time
    shard's cell), broadcast to every process."""
    src = mesh.time_cell(mesh.shape["time"] - 1)
    x = None
    if mesh.is_local(src):
        x = torch.as_tensor(np.asarray(tail, np.float32))
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"tail of shape {tuple(x.shape)}, expected {tuple(shape)}")
    return mesh.transport.broadcast(mesh, x, src, shape, torch.float32)


def make_global_input(mesh: PipelineMesh, local_body_slices: dict, tail, *, n_frames: int, hop: int, halo: int):
    """One block for the mesh program from this process's pieces:
    ``local_body_slices`` maps time shard -> its [body/T, 2] IQ pairs (the
    shards :func:`host_input_range` assigned here); ``tail`` [halo, 2] is
    passed by the process owning the stream end (None elsewhere) and
    broadcast.  Returns (body slices, tail) for ``pipeline_block`` with the
    mesh."""
    return _body_parts(mesh, local_body_slices), _tail(mesh, tail, (halo, 2))


def make_global_chain_input(mesh: PipelineMesh, local_bodies: dict, tails, *, k_blocks: int, n_frames: int, hop: int, halo: int):
    """Per-process ingest for the chained dispatch (``pipeline_chain`` with
    the mesh): ``local_bodies`` maps time shard -> [k_blocks, body/T, 2] IQ
    pairs (or [k_blocks, 2·body/T] raw); ``tails`` [k_blocks, halo, 2] from
    the process owning the stream end, None elsewhere.  Returns (bodies,
    tails) to pass as ``x``."""
    return _body_parts(mesh, local_bodies), _tail(mesh, tails, (k_blocks, halo, 2))


def local_audio_shards(audio: ChannelShards):
    """(device-order channel slice, ndarray) for every channel shard this
    process holds of a dense [W, C] or chained [K, W, C] output: what this
    process's sinks drain."""
    for part, sl in zip(audio.parts, audio.slices):
        if part is not None:
            yield sl, part.cpu().numpy()

