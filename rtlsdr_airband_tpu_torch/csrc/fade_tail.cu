// The fade-tail kernel: the block's assembly after K1 in one pass.
//
// It replaces no Pallas kernel.  The JAX package does the same rewrite in
// XLA (rtlsdr_airband_tpu/ops/demod.py::apply_fade_and_tail, a depthwise
// convolution of the close marks with the fade factors); the port did it in
// plain PyTorch (ops/demod.py::apply_fade_and_tail, which stays the oracle
// and the CPU path): a running maximum (torch.cummax, int64) over the mark
// positions of the whole [A + W, C] buffer, then a gather, a decay index and
// a select, about a dozen full-size tensors, most of them int64.
//
// What bounds it: it reads K1's audio [W, C] float32, the flag bytes [W, C]
// and the carried tail [A, C] once each, and writes the audio, the open
// flags and the new tail once each: 10 * W * C + 8 * A * C bytes, 170.4 MB
// at W = 2000, A = 100, C = 8192 (0.051 ms at 3.35 TB/s) and 47.4 MB at
// C = 2280 (0.014 ms).
//
// Why no scan: a close mark rewrites at most the A - 1 = 99 rows after it,
// so the mark that acts on a row lies within the 99 rows before it; the
// running maximum over the whole column is not needed.  Each column is cut
// into row segments (fade_tail.cuh); a thread takes one channel of one
// segment, finds the latest mark in the 99 flag rows before its segment
// (mostly from L2) and walks its rows with (last mark, its raw value) in
// registers, issuing ROWS_AHEAD rows' loads before it uses them.  The
// segment length comes from (W, C) and the SM count
// (fade_tail::segment_rows), so the grid fills the card at 2280 channels
// as at 8192.  Built with --fmad=false; the only arithmetic is one float32
// product a rewritten row, so the outputs equal the plain version's bit for
// bit.

#include "fade_tail.cuh"

namespace {

__global__ void __launch_bounds__(fade_tail::THREADS)
    fade_tail_kernel(const __grid_constant__ FadeTailArgs a, int seg_rows) {
  extern __shared__ float decay[];
  for (int i = threadIdx.x; i < a.A; i += blockDim.x) decay[i] = a.decay[i];
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.C) return;
  const int L = a.A + a.W;
  const int m0 = blockIdx.y * seg_rows;
  const int m1 = m0 + seg_rows < L ? m0 + seg_rows : L;
  fade_tail::segment(a, decay, c, m0, m1);
}

// The current card's SM count into *sms, or the error that kept it unread.
cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

}  // namespace

// One launch on `stream`, in segments of fade_tail::segment_rows rows.
// Returns a cudaError_t, 0 when the launch was taken; an SM count that
// cannot be read is an error, not a launch planned for a smaller card.
extern "C" int fade_tail_launch(const FadeTailArgs* a, void* stream) {
  if (a->W < 1 || a->C < 1 || a->A < 1) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int seg_rows = fade_tail::segment_rows(a->W, a->C, a->A, sms);
  const dim3 grid((a->C + fade_tail::THREADS - 1) / fade_tail::THREADS, (a->A + a->W + seg_rows - 1) / seg_rows);
  const size_t smem = static_cast<size_t>(a->A) * sizeof(float);
  fade_tail_kernel<<<grid, fade_tail::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(*a, seg_rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fade_tail_arg_names() { return FADE_TAIL_ARG_NAMES; }
