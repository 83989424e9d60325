// The CTCSS pass: the demod's second kernel (demod_ctcss.cu), after K1 on
// the same stream, and its host build (demod_host.cpp).
//
// K1 (demod_step_body.cuh) runs every channel's squelch, filters and
// demodulator, sample after sample, one thread a channel.  A CTCSS
// channel's two Goertzel banks (ctcss.cpp, 52 tones each), its tone gate
// and what the gate feeds (notch, ampfactor and clamp, the open flag, the
// gated IQ) only consume that chain: they read waveout, spa, adv_ct and
// ctcss_reset, and nothing upstream reads them back.  So K1 leaves them to
// this pass.  It writes waveout into the channel's audio where spa holds,
// and spa, adv_ct and ctcss_reset into bits 0, 2 and 3 of its flag bytes;
// the pass finishes those samples, one warp a channel, each lane holding
// tones lane and lane + 32 of both banks in registers.
//
// A warp walks its channel's W samples a tile of LANES at a time: lane i
// loads sample n0 + i's audio and flag byte (the next tile's loads in
// flight), and each sample of the tile is handed to every lane in turn, the
// next one taken while this one steps.  Per sample, in the plain version's order (ops/demod.py::_scan_step): the
// slow bank steps on adv_ct or resets on ctcss_reset; the fast bank steps on
// adv_ct while the slow one has no decision (after the slow one's update),
// or resets; the gate takes the slow bank's decision once it has one, else
// the fast one's; then the notch, ampfactor and clamp where spa and the gate
// open.  At a window's end each lane computes its tones' power, and every
// lane folds the 52 powers in tone order (max, masked total, tone 0), each
// taken from the lane that holds it: the decision rounds as the plain
// version's does, bit for bit, and every lane holds it.  A tile in which no
// sample is open, steps or resets is skipped whole: the banks do not move,
// and K1's outputs there (audio 0, flag bits 0, 2 and 3 clear, IQ 0) are
// final.  Each lane writes its own sample of the tile back: the audio, the
// flag byte with bit 0 the gated open flag and bits 2-3 cleared, and zeros
// into the IQ the gate shuts.
//
// A `Warp` is the policy of the lanes: the card's (demod_ctcss.cu) holds
// SLOTS = 2 tones a lane and moves values with warp shuffles; the host
// build's (demod_host.cpp) is one lane holding every tone and the whole
// tile.

#pragma once

#include "demod_step.cuh"

namespace ctcss {

using demod::MAX_TONES;

constexpr int LANES = 32;  // a warp: the lanes of one channel, and the samples of a tile

namespace flag = demod::flag;  // K1's flag bits

// One Goertzel bank of a channel as one lane holds it: the accumulators and
// coefficients of its SLOTS tones (slot k holds tone Warp::tone(k)), and,
// the same in every lane, the bank's scalar state and the mask of its tones.
template <int SLOTS>
struct Bank {
  float q1[SLOTS], q2[SLOTS], coeff[SLOTS];
  uint64_t mask;  // bit t: tone t is one of the bank's
  int32_t window, count, found, not_found;
  float ntones;
  bool enough, has_tone;
};

// A bank's leaves in the arguments, in load_bank's order: B is fast or slow.
#define CTCSS_BANK_IN(a, B)                                                                                  \
  a.s_##B##_q1, a.s_##B##_q2, a.p_##B##_coeff, a.p_##B##_mask, a.p_##B##_window[c], a.p_##B##_ntones[c],    \
      a.s_##B##_count[c], a.s_##B##_found[c], a.s_##B##_not_found[c], a.s_##B##_enough[c], a.s_##B##_has_tone[c]
#define CTCSS_BANK_OUT(a, B)                                                                                 \
  a.o_##B##_q1, a.o_##B##_q2, a.o_##B##_count + c, a.o_##B##_found + c, a.o_##B##_not_found + c,             \
      a.o_##B##_enough + c, a.o_##B##_has_tone + c

template <class Warp>
DEMOD_HD void load_bank(const Warp& w, Bank<Warp::SLOTS>& b, size_t C, int c, const float* q1, const float* q2,
                        const float* coeff, const uint8_t* mask, int32_t window, float ntones, int32_t count,
                        int32_t found, int32_t not_found, uint8_t enough, uint8_t has_tone) {
  bool m[Warp::SLOTS];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int k = 0; k < Warp::SLOTS; ++k) {
    const int t = w.tone(k);
    const size_t i = (size_t)t * C + c;
    const bool in = t < MAX_TONES;  // the card's last lanes hold no second tone
    b.q1[k] = in ? q1[i] : 0.0f;
    b.q2[k] = in ? q2[i] : 0.0f;
    b.coeff[k] = in ? coeff[i] : 0.0f;
    m[k] = in && mask[i] != 0;
  }
  b.mask = w.tone_bits(m);
  b.window = window;
  b.ntones = ntones;
  b.count = count;
  b.found = found;
  b.not_found = not_found;
  b.enough = enough != 0;
  b.has_tone = has_tone != 0;
}

template <class Warp>
DEMOD_HD void store_bank(const Warp& w, const Bank<Warp::SLOTS>& b, size_t C, int c, float* q1, float* q2,
                         int32_t* count, int32_t* found, int32_t* not_found, uint8_t* enough, uint8_t* has_tone) {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int k = 0; k < Warp::SLOTS; ++k) {
    const int t = w.tone(k);
    if (t < MAX_TONES) {
      q1[(size_t)t * C + c] = b.q1[k];
      q2[(size_t)t * C + c] = b.q2[k];
    }
  }
  if (w.leader()) {
    *count = b.count;
    *found = b.found;
    *not_found = b.not_found;
    *enough = b.enough ? 1 : 0;
    *has_tone = b.has_tone ? 1 : 0;
  }
}

// One sample into every tone's Goertzel recurrence (ctcss.cpp:44-61).
template <int S>
DEMOD_HD void tones_step(Bank<S>& b, float sample) {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int k = 0; k < S; ++k) {
    const float a = b.q1[k], z = b.q2[k];
    b.q2[k] = a;
    b.q1[k] = b.coeff[k] * a - z + sample;
  }
}

// One Goertzel-bank sample (ctcss.cpp:44-61,124-163), every float operation
// as ops/demod.py::_ctcss_bank_step orders it.
template <class Warp>
DEMOD_HD void bank_step(const Warp& w, Bank<Warp::SLOTS>& b, float sample, bool advance, bool reset) {
  constexpr int S = Warp::SLOTS;
  if (reset) {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int k = 0; k < S; ++k) {
      b.q1[k] = 0.0f;
      b.q2[k] = 0.0f;
    }
    b.count = 0;
    b.enough = false;
    b.has_tone = false;
  }
  if (!advance) return;
  tones_step(b, sample);
  b.count += 1;
  if (b.count < b.window) return;
  // window complete: max + average decision, then restart the window
  float power[S];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int k = 0; k < S; ++k) {
    const float x = b.q1[k], y = b.q2[k];
    power[k] = x * x + y * y - x * y * b.coeff[k];
    b.q1[k] = 0.0f;
    b.q2[k] = 0.0f;
  }
  float maxp = -INFINITY, total = 0.0f, p0 = 0.0f;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int t = 0; t < MAX_TONES; ++t) {
    const float p = w.tone_value(power, t);
    if (t == 0) p0 = p;
    const bool m = (b.mask >> t) & 1u;
    if (m && (p != p || p > maxp)) maxp = p;  // NaN propagates, as amax does
    total = total + (m ? p : 0.0f);
  }
  const float avg = total / b.ntones;
  const bool detected = (p0 == maxp) && (p0 > avg);
  b.has_tone = detected;
  b.enough = true;
  b.found += detected ? 1 : 0;
  b.not_found += detected ? 0 : 1;
  b.count = 0;
}

DEMOD_HD bool gate_of(bool slow_enough, bool slow_tone, bool fast_tone) { return slow_enough ? slow_tone : fast_tone; }

// The 32 samples of a whole tile into the slow bank, and into the fast one
// too when BOTH: every sample advances and no window ends inside the tile,
// so bank_step's checks all pass and only the recurrences remain.
template <bool BOTH, class Warp>
DEMOD_HD void run_tile(const Warp& w, Bank<Warp::SLOTS>& slow, Bank<Warp::SLOTS>& fast, const typename Warp::Tile& tile) {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int j = 0; j < LANES; ++j) {
    const float x = w.sample(tile, j);
    tones_step(slow, x);
    if (BOTH) tones_step(fast, x);
  }
  slow.count += LANES;
  if (BOTH) fast.count += LANES;
}

// The banks through the first `rows` samples of a tile (squelch.cpp:278-292):
// per sample the slow bank steps on adv_ct or resets, then the fast bank
// steps on adv_ct while the slow one has no decision, or resets.  Returns
// the gate after each sample, bit j for sample j.  A whole tile in which
// every sample advances and no window ends takes run_tile; where the gate
// cannot change, it is the tile's.
template <class Warp>
DEMOD_HD uint32_t banks_tile(const Warp& w, Bank<Warp::SLOTS>& slow, Bank<Warp::SLOTS>& fast, const typename Warp::Tile& tile,
                             int rows) {
  if (rows == LANES && w.all_advance(tile) && slow.count + LANES < slow.window &&
      (slow.enough || fast.count + LANES < fast.window)) {
    if (slow.enough)
      run_tile<false>(w, slow, fast, tile);
    else
      run_tile<true>(w, slow, fast, tile);
    return gate_of(slow.enough, slow.has_tone, fast.has_tone) ? ~0u : 0u;
  }
  uint32_t gates = 0;
#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
  for (int j = 0; j < rows; ++j) {
    float x;
    unsigned f;
    w.take(tile, j, x, f);
    const bool adv_ct = (f & flag::ADVANCE) != 0, reset = (f & flag::RESET) != 0;
    if (adv_ct || reset) {
      bank_step(w, slow, x, adv_ct, reset);
      bank_step(w, fast, x, adv_ct && !slow.enough, reset);
    }
    gates |= (gate_of(slow.enough, slow.has_tone, fast.has_tone) ? 1u : 0u) << j;
  }
  return gates;
}

// CTCSS channel c through the W samples of the block, after K1, on the
// lanes of `w`: the banks, the gate, the notch, ampfactor and clamp, the
// final audio and flag bytes, the IQ the gate shuts, and the channel's bank
// and notch leaves.
template <class Warp>
DEMOD_HD void pass_channel(const DemodArgs& a, int c, const Warp& w) {
  const size_t C = (size_t)a.C;
  Bank<Warp::SLOTS> fast, slow;
  load_bank(w, fast, C, c, CTCSS_BANK_IN(a, fast));
  load_bank(w, slow, C, c, CTCSS_BANK_IN(a, slow));
  const bool notch_en = a.p_notch_enabled[c] != 0;
  const float nd0 = a.p_notch_d0[c], nd1 = a.p_notch_d1[c], nd2 = a.p_notch_d2[c], amp = a.p_ampfactor[c];
  const bool iq_gated = a.with_iq && a.p_has_iq_outputs[c] != 0;
  float nx0 = a.s_notch_x[c], nx1 = a.s_notch_x[C + c], nx2 = a.s_notch_x[2 * C + c];
  float ny0 = a.s_notch_y[c], ny1 = a.s_notch_y[C + c], ny2 = a.s_notch_y[2 * C + c];

  typename Warp::Tile tile, next;
  w.load(a, c, 0, next);
#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
  for (int n0 = 0; n0 < a.W; n0 += LANES) {
    tile = next;
    if (n0 + LANES < a.W) w.load(a, c, n0 + LANES, next);  // in flight while this tile runs
    if (!w.active(tile)) continue;
    const int rows = (a.W - n0 < LANES) ? a.W - n0 : LANES;
    const uint32_t gates = banks_tile(w, slow, fast, tile, rows);

    // notch + ampfactor + clamp (rtl_airband.cpp:590-618), as demod_step_body.cuh
    if (notch_en) {  // a recurrence: sample after sample
#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
      for (int j = 0; j < rows; ++j) {
        float x;
        unsigned f;
        w.take(tile, j, x, f);
        const bool spa = (f & flag::OPEN) != 0, open_now = spa && ((gates >> j) & 1u);
        if (open_now) {
          nx0 = nx1; nx1 = nx2; nx2 = x;
        }
        const float nyn = nd0 * nx2 - nd1 * nx1 + nd0 * nx0 + nd1 * ny2 - nd2 * ny1;
        if (open_now) {
          ny0 = ny1; ny1 = ny2; ny2 = nyn;
        }
        const float w4 = nyn * amp;
        const float w5 = (w4 != w4) ? 0.0f : fminf(fmaxf(w4, -1.0f), 1.0f);
        w.keep(tile, j, open_now ? w5 : 0.0f, (f & flag::CLOSE_MARK) | (open_now ? flag::OPEN : 0u), spa && !open_now);
      }
    } else {  // each sample on its own lane
      w.each(tile, [&](int j, float x, unsigned f, float& out, unsigned& out_f, bool& zero_iq) {
        const bool spa = (f & flag::OPEN) != 0, open_now = spa && ((gates >> j) & 1u);
        const float w4 = x * amp;
        const float w5 = (w4 != w4) ? 0.0f : fminf(fmaxf(w4, -1.0f), 1.0f);
        out = open_now ? w5 : 0.0f;
        out_f = (f & flag::CLOSE_MARK) | (open_now ? flag::OPEN : 0u);
        zero_iq = spa && !open_now;
      });
    }
    w.store(a, c, n0, tile, iq_gated);
  }

  store_bank(w, fast, C, c, CTCSS_BANK_OUT(a, fast));
  store_bank(w, slow, C, c, CTCSS_BANK_OUT(a, slow));
  if (w.leader()) {
    a.o_notch_x[c] = nx0; a.o_notch_x[C + c] = nx1; a.o_notch_x[2 * C + c] = nx2;
    a.o_notch_y[c] = ny0; a.o_notch_y[C + c] = ny1; a.o_notch_y[2 * C + c] = ny2;
  }
}

}  // namespace ctcss
