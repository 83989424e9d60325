"""PyTorch/CUDA port of rtlsdr_airband_tpu for NVIDIA Hopper GPUs.

The package mirrors the layout of ``rtlsdr_airband_tpu`` so each module's
counterpart is easy to find.  It imports torch and numpy only: nothing of
JAX and nothing of the JAX package.  Plain tensor code is PyTorch; the
per-sample demod recurrence is a hand-written CUDA kernel that keeps its
rings, Goertzel banks and input tiles in shared memory (``csrc/demod.cu``,
launched by ``ops.demod_cuda.demod_block_cuda``), and
so is the chain-latency probe (``csrc/chain_probe.cu``, driven by
``scripts.bench_chain_probe``).

The program a user starts is ``python -m rtlsdr_airband_tpu_torch -c
<config>`` (``cli.py``, ``app.App``): a libconfig file, the input drivers,
the streaming ``runtime.pipeline.Pipeline`` and the sinks.

Entry points take ``device=`` (the CLI ``--device``) and default to
``"cuda"``; pass ``device="cpu"`` to run the plain PyTorch versions on the
CPU.
"""

__version__ = "0.1.0"
