// The CTCSS pass: the demod's second kernel, launched after K1 (demod.cu or
// demod_sched.cu) on the same stream when the block runs its CTCSS banks.
// demod_ctcss.cuh says what it does and why K1 leaves it this work.
//
// Counterpart of the CTCSS part of
// rtlsdr_airband_tpu/ops/demod_pallas.py::_make_kernel, which runs the banks
// inside its per-sample loop as K1 did before.
//
// Why a second kernel: inside K1 one thread stepped up to 2 x 52 tones a
// sample for its channel, on the serial chain of that channel's W samples,
// so the warps holding open CTCSS channels set K1's pace while the rest of
// the card idled (one open CTCSS channel among 8192 AM channels set the
// time of the whole kernel).  Here a warp takes one channel and each lane two tones of each
// bank, in registers: a sample costs the warp a few dozen instructions, not
// one thread's 104 tone steps.  A channel's samples stay a chain, so what
// bounds the pass is one warp walking the W samples of an open CTCSS
// channel; the channels run side by side.  Its bytes are K1's audio and flag
// bytes of each CTCSS channel, read once (5 W bytes a channel), and the open
// tiles rewritten.  Warps of other channels exit at once.
//
// Built with --fmad=false and without fast math, as K1 is, so the banks'
// accumulators, the decision and the notch round as the plain version's
// do, bit for bit.

#include <cuda_runtime.h>

#include "demod_ctcss.cuh"

namespace {

constexpr int WARPS = 4;  // channels a block, one warp each
constexpr unsigned FULL = 0xffffffffu;

// The card's lanes: lane l holds tones l and l + LANES of each bank, and
// sample n0 + l of a tile.
struct CardWarp {
  static constexpr int SLOTS = 2;
  static_assert(SLOTS * ctcss::LANES >= demod::MAX_TONES, "two tones a lane cover a bank");
  int lane;

  struct Tile {
    float x, out;  // K1's audio of this lane's sample; the pass's
    unsigned f, out_f;
    bool zero_iq;
  };

  __device__ __forceinline__ int tone(int k) const { return lane + ctcss::LANES * k; }
  __device__ __forceinline__ bool leader() const { return lane == 0; }

  // bit t: tone t's flag, from the lane that holds it
  __device__ __forceinline__ uint64_t tone_bits(const bool (&m)[SLOTS]) const {
    return (uint64_t)__ballot_sync(FULL, m[0]) | ((uint64_t)__ballot_sync(FULL, m[1]) << 32);
  }

  // tone t's value from the lane that holds it (t known when compiled)
  __device__ __forceinline__ float tone_value(const float (&p)[SLOTS], int t) const {
    return __shfl_sync(FULL, p[t / ctcss::LANES], t % ctcss::LANES);
  }

  __device__ __forceinline__ void load(const DemodArgs& a, int c, int n0, Tile& t) const {
    const int n = n0 + lane;
    const bool in = n < a.W;
    const size_t o = (size_t)n * a.C + c;
    t.x = in ? a.audio_raw[o] : 0.0f;
    t.f = in ? a.flags[o] : 0u;
  }

  __device__ __forceinline__ bool active(const Tile& t) const {
    return __any_sync(FULL, (t.f & (demod::flag::OPEN | demod::flag::ADVANCE | demod::flag::RESET)) != 0);
  }

  // every sample of the tile advances the banks and none resets them
  __device__ __forceinline__ bool all_advance(const Tile& t) const {
    return __all_sync(FULL, (t.f & (demod::flag::ADVANCE | demod::flag::RESET)) == demod::flag::ADVANCE);
  }

  // sample j's audio on every lane (j known when compiled)
  __device__ __forceinline__ float sample(const Tile& t, int j) const {
    return __shfl_sync(FULL, t.x, j);
  }

  __device__ __forceinline__ void take(const Tile& t, int j, float& x, unsigned& f) const {
    x = __shfl_sync(FULL, t.x, j);
    f = __shfl_sync(FULL, t.f, j);
  }

  __device__ __forceinline__ void keep(Tile& t, int j, float audio, unsigned flag, bool zero_iq) const {
    if (lane == j) {
      t.out = audio;
      t.out_f = flag;
      t.zero_iq = zero_iq;
    }
  }

  // fn(j, audio, flag, out, out_f, zero_iq) on this lane's own sample j
  template <class Fn>
  __device__ __forceinline__ void each(Tile& t, Fn fn) const {
    fn(lane, t.x, t.f, t.out, t.out_f, t.zero_iq);
  }

  __device__ __forceinline__ void store(const DemodArgs& a, int c, int n0, const Tile& t, bool iq_gated) const {
    const int n = n0 + lane;
    if (n >= a.W) return;
    const size_t o = (size_t)n * a.C + c;
    a.audio_raw[o] = t.out;
    a.flags[o] = (uint8_t)t.out_f;
    if (iq_gated && t.zero_iq) {
      a.iq_out[2 * o] = 0.0f;
      a.iq_out[2 * o + 1] = 0.0f;
    }
  }
};

__global__ void __launch_bounds__(WARPS * ctcss::LANES) demod_ctcss_kernel(const __grid_constant__ DemodArgs a) {
  const int c = blockIdx.x * WARPS + threadIdx.x / ctcss::LANES;
  if (!a.with_ctcss || c >= a.C || !a.p_ctcss_enabled[c]) return;  // the whole warp: it is one channel's
  ctcss::pass_channel(a, c, CardWarp{static_cast<int>(threadIdx.x % ctcss::LANES)});
}

}  // namespace

// One launch of the pass on `stream`, a warp a channel.  Returns a
// cudaError_t, 0 when the launch was taken.
extern "C" int demod_ctcss_launch(const DemodArgs* a, void* stream) {
  if (a->W < 1 || a->C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (a->C + WARPS - 1) / WARPS;
  demod_ctcss_kernel<<<blocks, WARPS * ctcss::LANES, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* demod_arg_names() { return DEMOD_ARG_NAMES; }
