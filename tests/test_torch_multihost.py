"""The port's multi-process mesh on the CPU: gloo processes of 2 CPU cells
each (a 2x2 ('time', 'chan') mesh), as tests/test_multihost.py runs the JAX
package's.  Each process ingests only its time slice and checks the
channels it holds against a single-process reference
(tests/torch_multihost_worker.py); then the multi-process runner
(``rtlsdr_airband_tpu_torch.scripts.run_multihost``) writes, across its
processes, the same WAV files a one-process run writes."""

import os
import socket
import subprocess
import sys

import pytest

from torch_port_common import scene_u8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_all(cmds: list, timeout: float) -> list:
    """Start every command at once; (exit code, output) of each, all killed
    if one overruns ``timeout``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def test_two_process_pipeline():
    coord = f"127.0.0.1:{_free_port()}"
    for i, (rc, out) in enumerate(_run_all([[sys.executable, WORKER, coord, str(i)] for i in range(2)], timeout=240)):
        assert rc == 0, f"process {i} failed:\n{out[-3000:]}"
        assert "ok=True" in out


# runs the runner's main() with K1's host build in place of the plain demod
# (the plain version takes some twenty times longer on this scene)
_RUNNER = (
    "import sys; import rtlsdr_airband_tpu_torch.runtime.pipeline as p; "
    "from rtlsdr_airband_tpu_torch.ops import demod_cuda; p.demod_block_cuda = demod_cuda.demod_block_host; "
    "from rtlsdr_airband_tpu_torch.scripts.run_multihost import main; sys.exit(main(sys.argv[1:]))"
)


@pytest.mark.parametrize("nproc, cells", [(2, 2), (3, 1)], ids=["2x2-mesh", "1x3-mesh"])
def test_runner_processes_write_the_one_process_wavs(tmp_path, nproc, cells):
    """The runner across ``nproc`` gloo processes: each writes WAVs for the
    channels it holds (3 channels: padded to 4 on the 2x2 mesh), together
    every channel once, each file equal byte for byte to a one-process run's
    (one cell, no exchange)."""
    iq = tmp_path / "scene.cu8"
    iq.write_bytes(scene_u8(0.9))
    chans = ", ".join(
        f'{{ freq = {f}; {kind} outputs: ( {{ type = "file"; directory = "{tmp_path}"; filename_template = "c{i}"; }} ); }}'
        for i, (f, kind) in enumerate([(120.4, ""), (120.7, 'modulation = "nfm"; ctcss = 100.0;'), (120.395, "bandwidth = 6000;")])
    )
    conf = tmp_path / "scene.conf"
    conf.write_text(f'fft_size = 512;\nwave_rate = 8000;\ndevices: ({{ type = "file"; filepath = "{iq}"; sample_format = "u8"; '
                    f'sample_rate = 2.56; centerfreq = 120.0; speedup_factor = 0.0; channels: ( {chans} ); }});\n')

    def runner(n, pid, c, out):
        return [sys.executable, "-c", _RUNNER, "--coordinator", coord, "--nproc", str(n), "--pid", str(pid),
                "--device", "cpu", "--cpu-devices", str(c), "-c", str(conf), "--outdir", str(tmp_path / out), "--chunk", "2"]

    coord = f"127.0.0.1:{_free_port()}"
    (rc, out), = _run_all([runner(1, 0, 1, "one")], timeout=240)
    assert rc == 0, out[-3000:]
    coord = f"127.0.0.1:{_free_port()}"
    results = _run_all([runner(nproc, i, cells, f"p{i}") for i in range(nproc)], timeout=240)
    for i, (rc, out) in enumerate(results):
        assert rc == 0, f"process {i} failed:\n{out[-3000:]}"
    want = sorted(os.listdir(tmp_path / "one"))
    assert want == ["ch0000.wav", "ch0001.wav", "ch0002.wav"]
    held = {f: i for i in range(nproc) for f in os.listdir(tmp_path / f"p{i}")}
    assert sorted(held) == want  # every channel once
    assert len(set(held.values())) > 1  # spread over the processes
    for f, i in held.items():
        assert (tmp_path / f"p{i}" / f).read_bytes() == (tmp_path / "one" / f).read_bytes(), f
