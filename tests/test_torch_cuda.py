"""The nvcc-built kernels against their plain PyTorch versions, on the card:
the demod kernel K1 and the chain-latency probe K2.

Needs an NVIDIA GPU and nvcc; skips without a card.  The file imports
neither jax nor the JAX package, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

K1 and K2 round every operation as their plain versions do: equal bit for
bit, K1 in every output and state leaf at both of its block widths.
"""

import ctypes

import numpy as np
import pytest
import torch

from rtlsdr_airband_tpu_torch import interop
from rtlsdr_airband_tpu_torch.constants import AGC_EXTRA
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.ops.demod import demod_block
from rtlsdr_airband_tpu_torch.ops.params import ChannelSpec, init_demod_state, make_channel_params
from rtlsdr_airband_tpu_torch.scripts import bench_chain_probe as probe
from torch_port_common import CENTER, FS, N, SPEC_KW, active_state, assert_bitwise, spec_population


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("block_width", demod_cuda.BLOCK_WIDTHS)
@pytest.mark.parametrize(
    "n_channels, W, fm_quadri, with_ctcss, with_iq",
    [
        (6, 200, False, True, True),
        (6, 200, True, False, True),
        (3, 100, False, True, False),
        (64, 131, False, True, False),
        (65, 257, True, True, True),
        (130, 131, True, True, False),
    ],
)
def test_kernel_matches_plain_on_card(cuda_device, block_width, n_channels, W, fm_quadri, with_ctcss, with_iq):
    """Three blocks, strong then weak signal, bit for bit in every output and
    state leaf.  C = 3, 6, 65 and 130 leave a ragged last block at both
    widths; W = 100 ends on the iq_tail rows, W = 131 and 257 end inside a
    32-sample input tile and cross n = 100 inside one."""
    specs = [ChannelSpec(**k) for k in spec_population(n_channels)]
    params = make_channel_params(specs, wave_rate=16000, sample_rate=FS, center_freq=CENTER, fft_size=N, device="cpu")
    rng = np.random.default_rng(6)
    ks = ps = active_state(params, n_channels, rng, cuda_device)
    params = type(params)(*(t.to(cuda_device) for t in params))
    for blk in range(3):
        mags = np.abs(rng.normal(0, 1.0, (W, n_channels)) + (3.0 if blk == 0 else 0.0)).astype(np.float32)
        iqs = rng.normal(0, 0.5, (W, n_channels, 2)).astype(np.float32)
        m, q = torch.from_numpy(mags).to(cuda_device), torch.from_numpy(iqs).to(cuda_device)
        before = demod_cuda.LAUNCHES
        kout = demod_cuda.demod_block_cuda(
            params, ks, m, q, fm_quadri=fm_quadri, with_ctcss=with_ctcss, with_iq=with_iq, block_width=block_width
        )
        assert demod_cuda.LAUNCHES == before + 1
        pout = demod_block(params, ps, m, q, fm_quadri=fm_quadri, with_ctcss=with_ctcss)
        torch.cuda.synchronize()
        if not with_iq:
            assert not kout[2].any()
            pout = (pout[0], pout[1], torch.zeros_like(pout[2]), pout[3])
        assert_bitwise(pout, kout, f"width {block_width} block {blk}")
        ks, ps = kout[0], pout[0]
    assert int(ps.open_count.sum()) > 0


@pytest.mark.cuda
def test_unbuilt_block_width_raises_before_launch(cuda_device):
    """A width the library was not built for is refused before any launch,
    by the wrapper and by the library's C entry."""
    specs = [ChannelSpec(**k) for k in SPEC_KW[:2]]
    params = make_channel_params(specs, wave_rate=8000, sample_rate=FS, center_freq=CENTER, fft_size=N, device=cuda_device)
    st = init_demod_state(2, torch.zeros(AGC_EXTRA, 2), torch.zeros(AGC_EXTRA, 2, 2))
    st = interop.state_from_numpy(interop.state_to_numpy(st), device=cuda_device)
    m, q = torch.zeros(120, 2, device=cuda_device), torch.zeros(120, 2, 2, device=cuda_device)
    before = demod_cuda.LAUNCHES
    with pytest.raises(ValueError, match="block width 48"):
        demod_cuda.demod_block_cuda(params, st, m, q, block_width=48)
    lib = demod_cuda.cuda_library()
    stream = torch.cuda.current_stream().cuda_stream
    codes = []
    demod_cuda.run_with(lambda args: codes.append(lib.demod_launch(ctypes.addressof(args), 48, stream)), lib, params, st, m, q, False, True, True)
    torch.cuda.synchronize()
    assert codes == [1]  # cudaErrorInvalidValue: nothing launched
    assert demod_cuda.LAUNCHES == before


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
