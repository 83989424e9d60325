"""The nvcc-built kernels against their plain PyTorch versions, on the card:
the demod kernel K1 and the chain-latency probe K2.

Needs an NVIDIA GPU and nvcc; skips without a card.  The file imports
neither jax nor the JAX package, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

K1's bars as in tests/test_demod_pallas.py: audio and IQ within 1e-4
absolute, open flags and int/bool state exact, float state within 1e-4.
K2 rounds every operation as its plain version does: equal bit for bit.
"""

import numpy as np
import pytest
import torch

from rtlsdr_airband_tpu_torch import interop
from rtlsdr_airband_tpu_torch.constants import AGC_EXTRA
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.ops.demod import OPEN, demod_block
from rtlsdr_airband_tpu_torch.ops.params import ChannelSpec, init_demod_state, make_channel_params
from rtlsdr_airband_tpu_torch.scripts import bench_chain_probe as probe
from torch_port_common import ATOL, CENTER, FS, N, SPEC_KW, assert_close


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _active_state(params, C, rng, device):
    """Low noise floor, high signal averages and the CTCSS channels OPEN with
    both Goertzel windows nearly full, so one short run opens and closes
    squelches and latches the banks (as in tests/test_torch_demod.py)."""
    st = init_demod_state(
        C,
        torch.from_numpy(np.abs(rng.normal(0, 1.0, (AGC_EXTRA, C))).astype(np.float32)),
        torch.from_numpy(rng.normal(0, 0.5, (AGC_EXTRA, C, 2)).astype(np.float32)),
    )
    d = interop.state_to_numpy(st)
    ct = params.ctcss_enabled.numpy()
    d["noise_floor"] = np.full(C, 0.3, np.float32)
    d["pre_full"] = d["pre_capped"] = np.full(C, 1.2, np.float32)
    d["cur"] = d["nxt"] = np.where(ct, OPEN, d["cur"]).astype(np.int32)
    for bank, left in (("fast", 40), ("slow", 100)):
        d[f"{bank}.count"] = np.where(ct, getattr(params, f"{bank}_window").numpy() - left, 0).astype(np.int32)
    return interop.state_from_numpy(d, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_channels, fm_quadri, with_ctcss, with_iq",
    [(6, False, True, True), (6, True, False, True), (3, False, True, False)],
)
def test_kernel_matches_plain_on_card(cuda_device, n_channels, fm_quadri, with_ctcss, with_iq):
    """Three blocks, strong then weak signal; C = 3 is the ragged edge of the
    64-thread block."""
    specs = [ChannelSpec(**k) for k in SPEC_KW[:n_channels]]
    params = make_channel_params(specs, wave_rate=8000, sample_rate=FS, center_freq=CENTER, fft_size=N, device="cpu")
    rng = np.random.default_rng(6)
    ks = ps = _active_state(params, n_channels, rng, cuda_device)
    params = type(params)(*(t.to(cuda_device) for t in params))
    W = 200
    for blk in range(3):
        mags = np.abs(rng.normal(0, 1.0, (W, n_channels)) + (3.0 if blk == 0 else 0.0)).astype(np.float32)
        iqs = rng.normal(0, 0.5, (W, n_channels, 2)).astype(np.float32)
        m, q = torch.from_numpy(mags).to(cuda_device), torch.from_numpy(iqs).to(cuda_device)
        before = demod_cuda.LAUNCHES
        kout = demod_cuda.demod_block_cuda(params, ks, m, q, fm_quadri=fm_quadri, with_ctcss=with_ctcss, with_iq=with_iq)
        assert demod_cuda.LAUNCHES == before + 1
        pout = demod_block(params, ps, m, q, fm_quadri=fm_quadri, with_ctcss=with_ctcss)
        torch.cuda.synchronize()
        assert (kout[1] - pout[1]).abs().max().item() < ATOL
        if with_iq:
            assert (kout[2] - pout[2]).abs().max().item() < ATOL
        else:
            assert not kout[2].any()
        assert torch.equal(kout[3], pout[3])
        assert_close(interop.state_to_numpy(pout[0]), interop.state_to_numpy(kout[0]), f"block {blk} state")
        ks, ps = kout[0], pout[0]
    assert int(ps.open_count.sum()) > 0


@pytest.mark.cuda
def test_launcher_rejects_cpu_state_with_cuda_data(cuda_device):
    """A CUDA tensor launches the kernel or raises: a state left on the CPU
    is refused, not run on the plain path."""
    specs = [ChannelSpec(**k) for k in SPEC_KW[:2]]
    params = make_channel_params(specs, wave_rate=8000, sample_rate=FS, center_freq=CENTER, fft_size=N, device=cuda_device)
    st = init_demod_state(2, torch.zeros(AGC_EXTRA, 2), torch.zeros(AGC_EXTRA, 2, 2))
    m, q = torch.zeros(120, 2, device=cuda_device), torch.zeros(120, 2, 2, device=cuda_device)
    before = demod_cuda.LAUNCHES
    with pytest.raises(ValueError, match="cpu"):
        demod_cuda.demod_block_cuda(params, st, m, q)
    assert demod_cuda.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind, subl, w_trips, links",
    [("chain1", 32, 20, 40), ("chain2", 32, 20, 4), ("chain1w", 64, 20, 40), ("chain2", 1, 7, 40), ("chain1", 32, 2000, 40)],
)
def test_chain_probe_matches_plain_on_card(cuda_device, kind, subl, w_trips, links):
    """Both rows, every element, bit for bit; the last case is the probe's
    own W and L; SUBL = 1 is two 64-thread blocks."""
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, subl, 128)).astype(np.float32)).to(cuda_device)
    before = probe.LAUNCHES
    got = probe.chain_probe(x, kind, w_trips, links)
    assert probe.LAUNCHES == before + 1
    want = probe.chain_probe_plain(x, kind, w_trips, links)
    torch.cuda.synchronize()
    assert got.shape == x.shape and torch.equal(got, want)
    assert torch.equal(got[1], x[1]) == (kind != "chain2")


@pytest.mark.cuda
def test_chain_probe_rejects_what_the_kernel_does_not_take(cuda_device):
    before = probe.LAUNCHES
    with pytest.raises(ValueError, match="contiguous"):
        probe.chain_probe(torch.zeros(2, 128, 32, device=cuda_device).transpose(1, 2), "chain1", 5)
    with pytest.raises(ValueError, match="compiled"):
        probe.chain_probe(torch.zeros(2, 32, 128, device=cuda_device), "chain1", 5, links=7)
    assert probe.LAUNCHES == before
