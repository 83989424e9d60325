"""Multi-process runner: every process runs this with the same config and
coordinator, ingests only ITS time slices of the IQ stream, runs the
chained sharded pipeline on the global mesh, and drains the channels IT
holds into WAV files of its own.

    # process 0                                       # process 1
    python -m rtlsdr_airband_tpu_torch.scripts.run_multihost \\
        --coordinator 10.0.0.1:9999 --nproc 2 --pid 0 \\    ... --pid 1 \\
        -c airband.conf --outdir /data/p0                     ... --outdir /data/p1

On one machine start the N processes with one port; process i takes
``cuda:i`` (NCCL needs a GPU a process).  On the CPU (gloo, two cells a
process):

    for i in 0 1; do python -m rtlsdr_airband_tpu_torch.scripts.run_multihost \\
        --coordinator 127.0.0.1:29512 --nproc 2 --pid $i --device cpu --cpu-devices 2 \\
        -c examples/multichannel.conf --outdir out/p$i & done; wait

Counterpart of the JAX package's ``scripts/run_multihost.py`` (same options,
plus ``--device``); the reference is a single process
(src/rtl_airband.cpp).  Each WAV is named by the user's channel index.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True, help="host:port of process 0")
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="cuda: NCCL, a GPU a process; cpu: gloo")
    ap.add_argument("--cpu-devices", type=int, default=1, help="mesh cells a process with --device cpu")
    ap.add_argument("--time-shards", type=int, default=None)
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--outdir", required=True, help="this process's audio directory (a WAV a channel)")
    ap.add_argument("--chunk", type=int, default=4, help="blocks per chained dispatch")
    args = ap.parse_args(argv)

    import torch

    from ..constants import AGC_EXTRA
    from ..io.wav import WavWriter
    from ..ops.params import init_demod_state
    from ..ops.sampleconv import SampleFormat, decode_iq
    from ..parallel import multihost
    from ..parallel.sharding import shard_last
    from ..runtime.config import load_config, pipeline_backend
    from ..runtime.pipeline import Pipeline, PipelineConfig, channelize_block, pipeline_chain

    cfg = load_config(args.config)
    d = cfg.devices[0]
    if d.type != "file" or not d.filepath:
        print("the multi-process runner needs a file-input device (a recording every process can read)", file=sys.stderr)
        return 2
    transport = multihost.initialize(args.coordinator, args.nproc, args.pid, device=args.device,
                                     local_cells=args.cpu_devices if args.device == "cpu" else 1)
    mesh = multihost.global_mesh(transport, time_shards=args.time_shards)
    if args.pid == 0:
        print(f"mesh: {mesh.shape} over {mesh.size} cell(s), {args.nproc} process(es)", flush=True)

    # the (mesh-mode) Pipeline builds the params, bins, taps and pad; the
    # loop below drives pipeline_chain with this process's pieces
    pcfg = PipelineConfig(
        sample_rate=d.sample_rate, center_freq=d.centerfreq, fft_size=cfg.fft_size, wave_rate=cfg.resolved_wave_rate(),
        sample_format="f32c", demod_backend=pipeline_backend(cfg.demod_backend), device=args.device, mesh=mesh,
    )
    pipe = Pipeline(pcfg, [ch.spec_for(0) for ch in d.channels])
    if pipe.device.type == "cuda":  # its params were made on the pipeline's stream; this loop runs on the current one
        torch.cuda.synchronize(pipe.device)
    W, hop, N = pipe.W, pipe.hop, pipe.N
    body, halo = W * hop, N - hop
    with open(d.filepath, "rb") as fh:
        fullscale = d.fullscale if d.fullscale is not None else {"s16": 32768.0, "f32": 1.0}.get(d.sample_format, 127.5)
        z = decode_iq(fh.read(), SampleFormat(d.sample_format), fullscale)  # [n, 2]

    # prime: every process computes the same small prefix
    prime_len = (AGC_EXTRA - 1) * hop + N
    mags, iqs = channelize_block(torch.as_tensor(z[:prime_len], device=pipe.device), pipe.bins, pipe.window,
                                 hop=hop, fft_size=N, n_frames=AGC_EXTRA, taps=pipe._taps)
    state = shard_last(mesh, init_demod_state(pipe.C_dev, mags, iqs), channel_dim=pipe.C_dev)
    z = z[AGC_EXTRA * hop :]

    ranges = multihost.host_input_range(mesh, n_frames=W, hop=hop, fft_size=N)
    local_body = body // mesh.shape["time"]
    owns_tail = any(h > 0 for _, _, h in ranges)
    bins, window, taps = pipe._block_args()
    os.makedirs(args.outdir, exist_ok=True)
    writers = {}
    K = max(1, args.chunk)
    n_blocks = 0
    while len(z) >= K * body + halo:
        local = {off // local_body: np.stack([z[j * body + off : j * body + off + blen] for j in range(K)]) for off, blen, _ in ranges}
        tails = np.stack([z[(j + 1) * body : (j + 1) * body + halo] for j in range(K)]) if owns_tail else None
        xg = multihost.make_global_chain_input(mesh, local, tails, k_blocks=K, n_frames=W, hop=hop, halo=halo)
        state, packed = pipeline_chain(
            xg, bins, window, pipe.params, state, k_blocks=K, hop=hop, fft_size=N, n_frames=W,
            fm_quadri=pcfg.fm_quadri, with_ctcss=pipe.any_ctcss, with_iq=False,
            demod_backend=pcfg.demod_backend, mesh=mesh, inv_perm=pipe._inv_perm, taps=taps,
        )
        # drain only the channels this process holds: device slot j is the
        # user's channel pipe._order[j]; the mesh pad (slots >= C) is dropped
        for sl, data in multihost.local_audio_shards(packed["audio"]):  # [K, W, Cb]
            for j in range(sl.start, min(sl.stop, pipe.C)):
                ci = int(pipe._order[j])
                if ci not in writers:
                    writers[ci] = WavWriter(os.path.join(args.outdir, f"ch{ci:04d}.wav"), pcfg.wave_rate)
                writers[ci].write_float(data[:, :, j - sl.start].reshape(-1))
        z = z[K * body :]
        n_blocks += K
        if args.pid == 0 and n_blocks % (4 * K) == 0:
            act = packed["active"].any(dim=0).cpu().numpy()
            print(f"[{n_blocks} blocks] active={np.flatnonzero(act).tolist()}", flush=True)
    for w in writers.values():
        w.close()
    transport.close()
    print(f"[proc {args.pid}] wrote {len(writers)} channel WAV(s), {n_blocks} blocks", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
