// K2: the chain-latency probe as a CUDA kernel for Hopper (sm_90a).
//
// Replaces scripts/bench_chain_probe.py::main.make (the pl.pallas_call at
// :91): W loop trips, each a chain of L dependent links
// v = v * 0.9995 + x * 1e-4 on every lane of row 0 of a [2, SUBL, 128]
// float32 tile, the state carried from trip to trip.  "chain1" runs one
// chain and leaves row 1 as x[1]; "chain2" runs a second, independent chain
// on row 1 (v * 0.9997 + x * 1e-4) interleaved link by link; the script's
// "chain1w" is chain1 at SUBL = 64.  The output is the final state.
//
// What bounds it on this card: not bytes (a tile is 32 KB in and out) and
// not FLOP/s (W * L * 2 flops a thread, about 0.01 ms of the card's float32
// peak for chain1), but the dependency chain: each thread issues W * L * 2
// float operations, each waiting on the one before, at the dependent
// latency of an FMUL or FADD (about 4 cycles).
//
// What the design does about it: nothing, on purpose; the probe exists to
// measure that chain.  It runs at K1's geometry (csrc/demod.cu): one thread
// per lane of row 0, 64 threads a block, the state in registers as K1 keeps
// its scalar state.  x * 1e-4 is loop-invariant and computed once; the L
// links are unrolled (L is a template parameter, as the TPU kernel's trace
// unrolls them), the W loop is a runtime loop.  Built with --fmad=false, so
// each link stays two dependent rounded operations (FMUL, then FADD), the
// TPU's chain depth, and the kernel equals its plain PyTorch version bit for
// bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // K1's kThreads

template <int L, bool kTwoChains>
__global__ void __launch_bounds__(kThreads)
    chain_probe_kernel(const float* __restrict__ x, float* __restrict__ out, int lanes, int w_trips) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  float a = x[i];
  float b = x[lanes + i];
  const float xa = a * 1e-4f;
  const float xb = b * 1e-4f;
  for (int t = 0; t < w_trips; ++t) {
#pragma unroll
    for (int k = 0; k < L; ++k) {
      a = a * 0.9995f + xa;
      if (kTwoChains) b = b * 0.9997f + xb;
    }
  }
  out[i] = a;
  out[lanes + i] = b;  // x[1] as it came in, unless a second chain ran
}

template <int L>
cudaError_t launch(const float* x, float* out, int chains, int lanes, int w_trips, cudaStream_t stream) {
  const int blocks = (lanes + kThreads - 1) / kThreads;
  if (chains == 1) {
    chain_probe_kernel<L, false><<<blocks, kThreads, 0, stream>>>(x, out, lanes, w_trips);
  } else {
    chain_probe_kernel<L, true><<<blocks, kThreads, 0, stream>>>(x, out, lanes, w_trips);
  }
  return cudaGetLastError();
}

}  // namespace

// x, out: float32 [2, lanes] on the device (row 0 then row 1, lanes = SUBL *
// 128); chains: 1 (chain1, chain1w) or 2 (chain2); links: 40 (the script's
// L) or 4 (the tests').  Returns a cudaError_t, 0 when the launch was taken.
extern "C" int chain_probe_launch(const float* x, float* out, int chains, int lanes, int links, int w_trips,
                                  void* stream) {
  if ((chains != 1 && chains != 2) || lanes < 1 || w_trips < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (links) {
    case 40:
      return static_cast<int>(launch<40>(x, out, chains, lanes, w_trips, s));
    case 4:
      return static_cast<int>(launch<4>(x, out, chains, lanes, w_trips, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
