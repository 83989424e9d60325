"""Worker process of tests/test_torch_multihost.py, one a simulated host: the
port's counterpart of tests/multihost_worker.py.

Each process joins a 2-process gloo group with 2 CPU cells, builds the
global ('time', 'chan') mesh (2 time x 2 chan), ingests only its own time
slice of a deterministic active scene, runs the port's sharded step and then
the chained dispatch (``pipeline_chain`` with the mesh), and checks the
channels it holds against a single-process reference of the same blocks,
bit for bit.  Exits 0 on a match.  Imports no JAX.

    python tests/torch_multihost_worker.py <host:port> <process id>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    coord, pid = sys.argv[1], int(sys.argv[2])

    import numpy as np
    import torch

    import rtlsdr_airband_tpu_torch.runtime.pipeline as port_pipeline
    from rtlsdr_airband_tpu_torch.models.flagship import build_flagship_stream
    from rtlsdr_airband_tpu_torch.ops import demod_cuda
    from rtlsdr_airband_tpu_torch.parallel import multihost
    from rtlsdr_airband_tpu_torch.parallel.sharding import make_sharded_pipeline_step, replicate, shard_last
    from rtlsdr_airband_tpu_torch.runtime.pipeline import META_I, pipeline_block, pipeline_chain

    # K1's own code (g++ build), on the shards and in the reference alike
    port_pipeline.demod_block_cuda = demod_cuda.demod_block_host
    transport = multihost.initialize(coord, 2, pid, device="cpu", local_cells=2)
    assert transport.world == 2 and len(transport.devices) == 2

    # an active multi-block scene: carriers on 3 of the 4 channels, spanning
    # both channel halves, 8 blocks with the state carried (the CTCSS tone
    # needs ~8 blocks to be confirmed)
    W, C, K = 128, 4, 8
    block, state, x_blocks, hot = build_flagship_stream(C, n_blocks=K, wave_batch=W, device="cpu")
    kw = {k: block.block_kwargs[k] for k in ("hop", "fft_size", "n_frames", "fm_quadri", "with_ctcss")}
    hop, N = kw["hop"], kw["fft_size"]
    mesh = multihost.global_mesh(transport, time_shards=2)
    assert mesh.shape == {"time": 2, "chan": 2} and [mesh.is_local(c) for c in range(4)] == [pid == 0] * 2 + [pid == 1] * 2
    step = make_sharded_pipeline_step(mesh, **kw)

    body, halo = W * hop, N - hop
    ranges = multihost.host_input_range(mesh, n_frames=W, hop=hop, fft_size=N)
    assert ranges == [(pid * body // 2, body // 2, halo if pid == 1 else 0)], ranges
    local_body = body // 2
    bins_r, window_r = replicate(mesh, block.bins), replicate(mesh, block.window)
    params_s = shard_last(mesh, block.params)
    assert [p is not None for p in params_s] == [pid == 0] * 2 + [pid == 1] * 2
    st, st_ref = shard_last(mesh, state), state

    def pieces(x):
        """This process's time slices of a block (and the tail where it owns
        the stream end): what it ingests."""
        local, owns_tail = {}, False
        for off, blen, halo_len in ranges:
            local[off // local_body] = x[off : off + blen].numpy()
            owns_tail |= halo_len > 0
        return local, owns_tail

    ok, checked, ever = True, 0, np.zeros(C, bool)
    for x in x_blocks:
        local, owns_tail = pieces(x)
        xg = multihost.make_global_input(mesh, local, x[body:].numpy() if owns_tail else None, n_frames=W, hop=hop, halo=halo)
        st, audio, _iq, active = step(xg, bins_r, window_r, params_s, st)
        st_ref, ref = pipeline_block(x, block.bins, block.window, block.params, st_ref, **kw)
        for sl, data in multihost.local_audio_shards(audio):
            ok &= data.tobytes() == ref["audio"][:, sl].numpy().tobytes()
            checked += 1
        ok &= torch.equal(active, ref["active"])  # replicated: every process holds all of it
        ever |= active.numpy()
    ok &= bool(ever[hot].all()) and len({h // (C // 2) for h in hot}) == 2

    # the chained production dispatch: k blocks a call, per-process ingest,
    # per-process drain of [K, W, Cb] shards, replicated meta
    kc, checked2 = 4, 0
    st_c, st_ref2 = shard_last(mesh, state), state
    for c0 in range(0, K, kc):
        chunk = x_blocks[c0 : c0 + kc]
        local = {t: np.stack([pieces(x)[0][t] for x in chunk]) for t in pieces(chunk[0])[0]}
        owns_tail = pieces(chunk[0])[1]
        tails = np.stack([x[body:].numpy() for x in chunk]) if owns_tail else None
        xg = multihost.make_global_chain_input(mesh, local, tails, k_blocks=len(chunk), n_frames=W, hop=hop, halo=halo)
        st_c, packed = pipeline_chain(xg, bins_r, window_r, params_s, st_c, k_blocks=len(chunk), mesh=mesh, **kw)
        refs = []
        for x in chunk:
            st_ref2, r = pipeline_block(x, block.bins, block.window, block.params, st_ref2, **kw)
            refs.append(r)
        ref_audio = torch.stack([r["audio"] for r in refs])
        for sl, data in multihost.local_audio_shards(packed["audio"]):
            ok &= data.tobytes() == ref_audio[:, :, sl].numpy().tobytes()
            checked2 += 1
        ok &= torch.equal(packed["meta_i"][:, META_I.index("open_count")], torch.stack([r["open_count"] for r in refs]))
        ok &= torch.equal(packed["active"], torch.stack([r["active"] for r in refs]))
    ok &= checked2 > 0

    print(f"[proc {pid}] checked {checked} audio shards over {K} blocks (+{checked2} chained), "
          f"active={np.flatnonzero(ever).tolist()}, ok={ok}", flush=True)
    transport.close()
    return 0 if ok and checked > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
