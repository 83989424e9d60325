"""PyTorch/CUDA port of rtlsdr_airband_tpu for NVIDIA Hopper GPUs.

The package mirrors the layout of ``rtlsdr_airband_tpu`` so each module's
counterpart is easy to find.  It imports torch and numpy only: nothing of
JAX and nothing of the JAX package.  Plain tensor code is PyTorch; the
per-sample demod recurrence is a hand-written CUDA kernel
(``csrc/demod.cu``, launched by ``ops.demod_cuda.demod_block_cuda``).

Entry points take ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions on the CPU.
"""

__version__ = "0.1.0"
