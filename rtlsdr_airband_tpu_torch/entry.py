"""Driver entry points: the flagship block step, and the App over a mesh of
devices held against one device.

Counterpart of the JAX package's ``__graft_entry__.py``.

    python -m rtlsdr_airband_tpu_torch.entry                   # NDEV GPUs (default 8)
    NDEV=4 python -m rtlsdr_airband_tpu_torch.entry --device cpu   # four CPU cells

The JAX script falls back to a virtual CPU mesh when the platform has fewer
devices than asked for; here the mesh is made of distinct GPUs, or of CPU
cells when the caller asks for the CPU, and fewer GPUs than ``NDEV`` is an
error.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ENTRY_CHANNELS = 8192


def entry(device="cuda", n_channels: int = ENTRY_CHANNELS):
    """``(fn, example_args)``: the flagship block program (fused channelize +
    demod over a mixed AM/NFM/CTCSS population, bench.py's shapes) and its
    input block and initial state; ``fn(*example_args) -> (state', outputs)``.
    On the card the demod is the kernel K1."""
    from .models.flagship import build_flagship

    block, x, state = build_flagship(n_channels=n_channels, wave_rate=16000, device=device)
    return block, (x, state)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Run the production App path over a mesh of ``n_devices``: libconfig
    text with ``mesh_devices`` -> App -> file input thread -> ring buffer ->
    mesh-mode Pipeline (chained dispatch, the time-sharded channelizer with
    its halo exchange, the demod once per channel shard, the reshard
    between them) -> per-channel sinks.  The scene opens squelch on carriers
    in several channel shards and gates one off mid-stream, so the open and
    close paths run across the reshard, and the stream drains through
    flush().  The meshed audio is then asserted bit for bit equal to a
    single-device App run of the same scene.

    ``device="cuda"``: the first ``n_devices`` GPUs, K1 once a channel shard
    (the JAX script runs its XLA scan; the port runs what its App runs on
    the card).  ``device="cpu"``: ``n_devices`` CPU cells and the plain
    versions."""
    import tempfile

    from .app import App
    from .runtime.config import loads_config
    from .utils.siggen import am_carrier_iq, complex_noise

    # small-rate scene: fs=256 kHz, hop=32, W=1000 (wave_rate 8000), fft 512
    # -> halo 480.  Carriers on 3 channels spanning different channel shards;
    # the first gates OFF mid-stream.
    fs, center, wr = 256_000, 120_000_000, 8000
    C, n_blocks = 8, 6
    hop = fs // wr
    n = 100 * hop + n_blocks * 1000 * hop + 512  # prime + blocks + halo
    freqs = [center - 96_000 + 24_000 * i for i in range(C)]
    hot = [0, 3, 6]
    z = complex_noise(n, 0.01, seed=3)
    gate = np.ones(n, np.float32)
    gate[int(n * 0.55) :] = 0.0
    z += am_carrier_iq(fs, freqs[hot[0]] - center, n, carrier_ampl=0.4) * gate
    for ci in hot[1:]:
        z += am_carrier_iq(fs, freqs[ci] - center, n, carrier_ampl=0.4)
    u8 = np.empty(2 * n, np.uint8)
    u8[0::2] = np.clip(np.round(z.real * 127.5 + 127.5), 0, 255).astype(np.uint8)
    u8[1::2] = np.clip(np.round(z.imag * 127.5 + 127.5), 0, 255).astype(np.uint8)

    with tempfile.TemporaryDirectory(prefix="dryrun_mesh_") as tmp:
        iq_path = os.path.join(tmp, "scene.cu8")
        u8.tofile(iq_path)
        chans = ", ".join(
            f'{{ freq = {f}; modulation = "am"; outputs: ( {{ type = "udp_stream"; '
            f'dest_address = "127.0.0.1"; dest_port = {21000 + i}; }} ); }}'
            for i, f in enumerate(freqs)
        )

        def make_cfg(mesh_devices: int):
            return loads_config(
                f"fft_size = 512;\nwave_rate = {wr};\nmesh_devices = {mesh_devices};\n"
                f"blocks_per_dispatch = 2;\n"
                f'devices: ( {{ type = "file"; filepath = "{iq_path}"; centerfreq = {center}; '
                f'sample_rate = {fs}; sample_format = "u8"; speedup_factor = 0.0; '
                f"channels: ( {chans} ); }} );\n"
            )

        def run_app(mesh_devices: int):
            app = App(make_cfg(mesh_devices), device=device)
            blocks = []
            orig = app._handle_block

            def record(rt, out):
                blocks.append((np.array(out["audio"]), np.array(out["active"])))
                orig(rt, out)

            app._handle_block = record
            app.run(max_seconds=600.0)
            return app, blocks

        app, blocks = run_app(n_devices)
        mesh = app.mesh
        if mesh is None or mesh.size != n_devices:
            raise AssertionError(f"dryrun_multichip: mesh {mesh}, expected {n_devices} cells")
        if len(blocks) != n_blocks:
            raise AssertionError(f"dryrun_multichip: {len(blocks)} blocks, expected {n_blocks}")
        ever_active = np.zeros(C, bool)
        for audio, act in blocks:
            if audio.shape != (wr // 8, C) or not np.isfinite(audio).all():
                raise AssertionError(f"dryrun_multichip: audio {audio.shape} not finite or misshapen")
            ever_active |= act
        if not ever_active[hot].all():
            raise AssertionError(f"dryrun_multichip: hot channels {hot}, opened {np.flatnonzero(ever_active)}")
        csh = mesh.shape["chan"]
        shard_of = {h // max(1, C // csh) for h in hot}
        reclosed = not bool(blocks[-1][1][hot[0]])  # the gated-off carrier closed again
        if not reclosed:
            raise AssertionError(f"dryrun_multichip: channel {hot[0]} did not close after its carrier went off")

        # sharding correctness: the mesh's audio bit for bit equal to the same
        # scene through a single-device (unsharded) App
        app1, single = run_app(0)
        if app1.mesh is not None or len(single) != len(blocks):
            raise AssertionError(f"dryrun_multichip: single-device App gave {len(single)} blocks")
        for k, ((sa, sact), (ma, mact)) in enumerate(zip(single, blocks)):
            if sa.tobytes() != ma.tobytes() or not np.array_equal(sact, mact):
                raise AssertionError(f"dryrun_multichip: block {k} differs between the mesh and one device")
    print(
        f"dryrun_multichip OK: App path, mesh={dict(mesh.shape)} over {[str(d) for d in mesh.cells]} blocks={len(blocks)} "
        f"active={int(ever_active.sum())} hot={hot} hot_shards={sorted(shard_of)} "
        f"reclose={reclosed} mesh==single bit-identical over {len(blocks)} blocks",
        flush=True,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the App over a mesh of NDEV devices against one device")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="cpu: a mesh of CPU cells")
    args = ap.parse_args(argv)
    n = int(os.environ.get("NDEV", "8"))
    if args.device == "cuda" and torch.cuda.device_count() < n:
        print(f"entry: NDEV={n} needs {n} GPUs, this machine has {torch.cuda.device_count()} "
              f"(--device cpu runs the mesh on CPU cells)", file=sys.stderr)
        return 1
    dryrun_multichip(n, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
