// Per-channel demod recurrence shared by the CUDA kernel (demod.cu) and a
// host build of the same code (demod_host.cpp, for the CPU tests).
//
// demod_channel() advances ONE channel through the W samples of a block
// (demod_pair() two channels, sample by sample together): the reference's
// whole per-sample loop (src/rtl_airband.cpp:495-648 with
// squelch.cpp, ctcss.cpp and filters.cpp).  It is the operation-for-operation
// transcription of the plain PyTorch version, ops/demod.py::_scan_step:
// every float operation is written in the same order, so that with
// contraction to fused multiply-add turned off (nvcc --fmad=false,
// g++ -ffp-contract=off) each one rounds as the plain version's does and
// every output and every state leaf comes out equal, bit for bit.
//
// Layout: every per-channel array of the arguments is [rows, C] with the
// channel fastest, so the threads of a warp (consecutive channels) touch
// consecutive addresses.  Where the step keeps its rings (a Column) and
// where it takes each sample from (a source) are the caller's:
// demod_tiles.cuh holds them, the kernel's shared-memory tiles for one
// channel and for a pair.  The step itself is demod_step_body.cuh, run by
// demod_channel and by Channel::step.
//
// A CTCSS channel's Goertzel banks, its tone gate and what the gate feeds
// (notch, ampfactor and clamp, the open flag, the gated IQ) are not run
// here: the step writes what they need into the channel's audio and flag
// bytes, and the CTCSS pass after it (demod_ctcss.cuh) finishes them, the
// tones spread over a warp's lanes.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define DEMOD_HD __host__ __device__ __forceinline__
#else
#define DEMOD_HD inline
#endif

namespace demod {

constexpr int CLOSED = 0, OPENING = 1, CLOSING = 2, LSA = 3, OPEN = 4;
constexpr int OPEN_DELAY = 197, CLOSE_DELAY = 197, LOW_SIGNAL_ABORT = 88;
constexpr int RECENT_SAMPLE_SIZE = 1000, FLAP_OPENS_THRESHOLD = 3;
constexpr int SQ_BUF = 102;     // squelch pre/post comparison ring
constexpr int AGC_EXTRA = 100;  // wavein delay line / IQ lag
constexpr int MAX_TONES = 52;   // CTCSS tones per bank
constexpr int LUT_ENTRIES = 257;

constexpr float PRE_VS_POST = 0.9f;
constexpr float MA_DECAY = 0.99f;
constexpr float MA_NEW = 1.0f - 0.99f;
constexpr float NF_DECAY = 0.97f;
constexpr float NF_NEW = 1.0f - 0.97f;
constexpr float NF_BIAS = 1e-6f;
constexpr float PI4 = (float)(3.14159265358979323846 / 4.0);
constexpr float PI34 = (float)(3.0 * 3.14159265358979323846 / 4.0);
constexpr float M1PI = (float)(1.0 / 3.14159265358979323846);

// The bits of K1's flag bytes (DemodArgs::flags).  OPEN is the open flag
// and CLOSE_MARK the AM close mark the fade-tail kernel reads.  On a CTCSS
// channel K1 writes spa into OPEN, adv_ct into ADVANCE and ctcss_reset into
// RESET, and the CTCSS pass leaves OPEN the gated open flag and clears the
// other two.
namespace flag {
constexpr unsigned OPEN = 1, CLOSE_MARK = 2, ADVANCE = 4, RESET = 8;
}  // namespace flag

}  // namespace demod

// Carried state, one entry per DemodState leaf (CTCSS banks flattened as
// fast_* / slow_*).  S(X, type, name).
#define DEMOD_STATE_FIELDS(S, X)                                                      \
  S(X, float, noise_floor) S(X, float, pre_full) S(X, float, pre_capped)               \
  S(X, float, post_full) S(X, float, post_capped) S(X, uint8_t, using_post_filter)     \
  S(X, int32_t, cur) S(X, int32_t, nxt) S(X, int32_t, delay)                           \
  S(X, int32_t, low_signal_count) S(X, int32_t, sample_count) S(X, int32_t, open_count) \
  S(X, int32_t, flappy_count) S(X, int32_t, recent_open_count)                         \
  S(X, int32_t, closed_sample_count) S(X, float, sq_buffer)                            \
  S(X, float, lp_xr) S(X, float, lp_xi) S(X, float, lp_yr) S(X, float, lp_yi)          \
  S(X, float, notch_x) S(X, float, notch_y) S(X, float, agc) S(X, int32_t, dm_phi)     \
  S(X, float, pr) S(X, float, pj) S(X, float, prev_waveout)                            \
  S(X, float, fast_q1) S(X, float, fast_q2) S(X, int32_t, fast_count)                  \
  S(X, uint8_t, fast_enough) S(X, uint8_t, fast_has_tone) S(X, int32_t, fast_found)    \
  S(X, int32_t, fast_not_found)                                                        \
  S(X, float, slow_q1) S(X, float, slow_q2) S(X, int32_t, slow_count)                  \
  S(X, uint8_t, slow_enough) S(X, uint8_t, slow_has_tone) S(X, int32_t, slow_found)    \
  S(X, int32_t, slow_not_found) S(X, float, wavein_delay)

#define DEMOD_STATE_IN(X, T, n) X(const T*, s_##n)
#define DEMOD_STATE_OUT(X, T, n) X(T*, o_##n)

// Every pointer the kernel takes, in struct order.  X(type, name).
#define DEMOD_ARG_POINTERS(X)                                                          \
  /* data in: mags [W, C]; iqs [W, C, 2]; carried iq_tail [AGC_EXTRA, C, 2] */         \
  X(const float*, mags) X(const float*, iqs) X(const float*, iq_tail)                  \
  /* ChannelParams */                                                                  \
  X(const uint8_t*, p_is_nfm) X(const uint8_t*, p_needs_raw_iq)                        \
  X(const uint8_t*, p_has_iq_outputs) X(const int32_t*, p_dm_dphi)                     \
  X(const float*, p_alpha) X(const float*, p_ampfactor) X(const uint8_t*, p_using_manual) \
  X(const float*, p_manual_level) X(const float*, p_normal_ratio)                      \
  X(const float*, p_flappy_ratio) X(const uint8_t*, p_lp_enabled)                      \
  X(const float*, p_lp_gain) X(const float*, p_lp_y0) X(const float*, p_lp_y1)         \
  X(const uint8_t*, p_notch_enabled) X(const float*, p_notch_d0)                       \
  X(const float*, p_notch_d1) X(const float*, p_notch_d2)                              \
  X(const uint8_t*, p_ctcss_enabled) X(const float*, p_fast_coeff)                     \
  X(const uint8_t*, p_fast_mask) X(const int32_t*, p_fast_window)                      \
  X(const float*, p_fast_ntones) X(const float*, p_slow_coeff)                         \
  X(const uint8_t*, p_slow_mask) X(const int32_t*, p_slow_window)                      \
  X(const float*, p_slow_ntones) X(const float*, p_sin_lut) X(const float*, p_cos_lut) \
  /* DemodState in and out */                                                          \
  DEMOD_STATE_FIELDS(DEMOD_STATE_IN, X)                                                \
  DEMOD_STATE_FIELDS(DEMOD_STATE_OUT, X)                                               \
  /* outputs: audio before fade assembly [W, C]; flags [W, C] (the bits of         \
     demod::flag); gated IQ [W, C, 2], only written when with_iq */                     \
  X(float*, audio_raw) X(uint8_t*, flags) X(float*, iq_out)

struct DemodArgs {
#define DEMOD_DECL(T, n) T n;
  DEMOD_ARG_POINTERS(DEMOD_DECL)
#undef DEMOD_DECL
  int32_t W, C, fm_quadri, with_ctcss, with_iq;
};

// Field names in struct order, comma-separated: the Python side builds its
// ctypes mirror of DemodArgs from this string.
#define DEMOD_NAME(T, n) #n ","
#define DEMOD_ARG_NAMES DEMOD_ARG_POINTERS(DEMOD_NAME) "W,C,fm_quadri,with_ctcss,with_iq"

namespace demod {

DEMOD_HD float levels(bool useman, float manual, float nratio, float fratio, float nf, int32_t roc) {
  // eager squelch_level() (squelch.cpp:169-177)
  const bool flapping = roc >= FLAP_OPENS_THRESHOLD;
  const float ratio = (flapping && fratio < nratio) ? fratio : nratio;
  return useman ? manual : ratio * nf;
}

DEMOD_HD float min_nan(float a, float b) {
  // torch.minimum / jnp.minimum: a NaN operand propagates (fminf drops it)
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

DEMOD_HD int32_t set_state_valid(int32_t cur, int32_t u) {
  // transition-validity table (squelch.cpp:297-361)
  if (cur == CLOSED && (u == CLOSING || u == LSA)) u = CLOSED;
  if (cur == CLOSED && u == OPEN) u = OPENING;
  if (cur == OPENING && u == LSA) u = CLOSED;
  if (cur == LSA && u != LSA && u != CLOSED) u = CLOSED;
  if (cur == OPEN && u == CLOSED) u = CLOSING;
  if (cur == OPEN && u == OPENING) u = OPEN;
  return u;
}

DEMOD_HD float fast_atan2(float y, float x) {
  // rtl_airband.cpp:147-166
  const float yabs = fabsf(y);
  float angle = (x >= 0.0f) ? PI4 - PI4 * (x - yabs) / (x + yabs) : PI34 - PI4 * (x + yabs) / (yabs - x);
  if (y < 0.0f) angle = -angle;
  return (x == 0.0f && y == 0.0f) ? 0.0f : angle;
}

// Where one channel's rings live: pointers at its row 0, consecutive rows
// `stride` elements apart, each holding the rotating ring (slot n % rows).
struct Column {
  float *sq, *dl;  // squelch ring [SQ_BUF], wavein delay line [AGC_EXTRA]
  size_t stride;
};

// Rows 0 .. ROWS - 1 of channel c's column of a [rows, C] leaf, from src to
// dst: every row loaded before any is stored, so the loads overlap.  (The
// compiler cannot tell that the two never alias, so a row's load and store
// in turn wait a memory round trip each.)
template <int ROWS, class T>
DEMOD_HD void carry_rows(T* dst, const T* src, size_t C, int c) {
  T v[ROWS];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int k = 0; k < ROWS; ++k) v[k] = src[k * C + c];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int k = 0; k < ROWS; ++k) dst[k * C + c] = v[k];
}

// Every name the step body (demod_step_body.cuh) reads or writes besides
// `a`, `n`, `src`, `sin_lut`, `cos_lut`: where the channel's rings are, its
// loop-invariant params and its carried scalar state.  X(type, name).
#define DEMOD_CHANNEL_VARS(X)                                                                       \
  X(int, c) X(size_t, Cs) X(size_t, S) X(Column, col) X(float*, sq) X(float*, dl)                   \
  X(bool, is_nfm) X(bool, is_am) X(bool, needs_iq) X(bool, iq_outs) X(uint32_t, dphi)               \
  X(float, alpha) X(float, amp) X(bool, useman) X(float, manual) X(float, nratio) X(float, fratio)  \
  X(bool, lp_en) X(float, lp_gain) X(float, lp_y0) X(float, lp_y1) X(bool, notch_en)                \
  X(float, nd0) X(float, nd1) X(float, nd2) X(bool, ctcss_en)                                       \
  X(float, nf) X(float, pre_full) X(float, pre_capped) X(float, post_full) X(float, post_capped)    \
  X(bool, upf) X(int32_t, cur) X(int32_t, nxt) X(int32_t, delay) X(int32_t, lsc)                    \
  X(int32_t, sample_count) X(int32_t, open_count) X(int32_t, flappy) X(int32_t, roc)                \
  X(int32_t, csc) X(float, agc) X(float, pr) X(float, pj) X(float, prev) X(uint32_t, phi)           \
  X(float, xr0) X(float, xr1) X(float, xr2) X(float, xi0) X(float, xi1) X(float, xi2)               \
  X(float, yr0) X(float, yr1) X(float, yr2) X(float, yi0) X(float, yi1) X(float, yi2)               \
  X(float, nx0) X(float, nx1) X(float, nx2) X(float, ny0) X(float, ny1) X(float, ny2)               \
  X(int, pos_sq) X(int, pos_dl)

// One channel of the block: load() reads its params and carried state from
// the arguments (its rings into `col`, row 0 oldest), step() advances it one
// sample, store() writes the state back.  `ctcss_en` holds only where the
// CTCSS pass runs (with_ctcss on): the pass then writes the channel's bank
// leaves, and store() carries every other channel's through.
struct Channel {
#define DEMOD_MEMBER(T, name) T name;
  DEMOD_CHANNEL_VARS(DEMOD_MEMBER)
#undef DEMOD_MEMBER

  DEMOD_HD void load(const DemodArgs& a, int ch, const Column& column) {
    c = ch;
    Cs = (size_t)a.C;
    col = column;
    S = col.stride;

    // ---- loop-invariant params ----
    is_nfm = a.p_is_nfm[c] != 0;
    is_am = !is_nfm;
    needs_iq = a.p_needs_raw_iq[c] != 0;
    iq_outs = a.p_has_iq_outputs[c] != 0;
    dphi = (uint32_t)a.p_dm_dphi[c];
    alpha = a.p_alpha[c]; amp = a.p_ampfactor[c];
    useman = a.p_using_manual[c] != 0;
    manual = a.p_manual_level[c]; nratio = a.p_normal_ratio[c]; fratio = a.p_flappy_ratio[c];
    lp_en = a.p_lp_enabled[c] != 0;
    lp_gain = a.p_lp_gain[c]; lp_y0 = a.p_lp_y0[c]; lp_y1 = a.p_lp_y1[c];
    notch_en = a.p_notch_enabled[c] != 0;
    nd0 = a.p_notch_d0[c]; nd1 = a.p_notch_d1[c]; nd2 = a.p_notch_d2[c];
    ctcss_en = a.with_ctcss && a.p_ctcss_enabled[c] != 0;

    // ---- scalar state ----
    nf = a.s_noise_floor[c]; pre_full = a.s_pre_full[c]; pre_capped = a.s_pre_capped[c];
    post_full = a.s_post_full[c]; post_capped = a.s_post_capped[c];
    upf = a.s_using_post_filter[c] != 0;
    cur = a.s_cur[c]; nxt = a.s_nxt[c]; delay = a.s_delay[c]; lsc = a.s_low_signal_count[c];
    sample_count = a.s_sample_count[c]; open_count = a.s_open_count[c];
    flappy = a.s_flappy_count[c]; roc = a.s_recent_open_count[c]; csc = a.s_closed_sample_count[c];
    agc = a.s_agc[c]; pr = a.s_pr[c]; pj = a.s_pj[c]; prev = a.s_prev_waveout[c];
    phi = (uint32_t)a.s_dm_phi[c];
    xr0 = a.s_lp_xr[c]; xr1 = a.s_lp_xr[Cs + c]; xr2 = a.s_lp_xr[2 * Cs + c];
    xi0 = a.s_lp_xi[c]; xi1 = a.s_lp_xi[Cs + c]; xi2 = a.s_lp_xi[2 * Cs + c];
    yr0 = a.s_lp_yr[c]; yr1 = a.s_lp_yr[Cs + c]; yr2 = a.s_lp_yr[2 * Cs + c];
    yi0 = a.s_lp_yi[c]; yi1 = a.s_lp_yi[Cs + c]; yi2 = a.s_lp_yi[2 * Cs + c];
    nx0 = a.s_notch_x[c]; nx1 = a.s_notch_x[Cs + c]; nx2 = a.s_notch_x[2 * Cs + c];
    ny0 = a.s_notch_y[c]; ny1 = a.s_notch_y[Cs + c]; ny2 = a.s_notch_y[2 * Cs + c];

    // ---- rings into their column, row 0 oldest ----
    sq = col.sq;
    dl = col.dl;
    for (int k = 0; k < SQ_BUF; ++k) sq[k * S] = a.s_sq_buffer[k * Cs + c];
    for (int k = 0; k < AGC_EXTRA; ++k) dl[k * S] = a.s_wavein_delay[k * Cs + c];
    // rotating ring positions: slot pos_sq holds the oldest entry (n % SQ_BUF)
    pos_sq = 0;
    pos_dl = 0;
  }

  // Sample n, taken from `src` (src.at(n, s, r, i): magnitude and IQ pair).
  template <class Src>
  DEMOD_HD void step(const DemodArgs& a, const float* sin_lut, const float* cos_lut, int n, Src& src) {
#include "demod_step_body.cuh"
  }

  DEMOD_HD void store(const DemodArgs& a) const {
    a.o_noise_floor[c] = nf; a.o_pre_full[c] = pre_full; a.o_pre_capped[c] = pre_capped;
    a.o_post_full[c] = post_full; a.o_post_capped[c] = post_capped; a.o_using_post_filter[c] = upf ? 1 : 0;
    a.o_cur[c] = cur; a.o_nxt[c] = nxt; a.o_delay[c] = delay; a.o_low_signal_count[c] = lsc;
    a.o_sample_count[c] = sample_count; a.o_open_count[c] = open_count; a.o_flappy_count[c] = flappy;
    a.o_recent_open_count[c] = roc; a.o_closed_sample_count[c] = csc;
    a.o_agc[c] = agc; a.o_dm_phi[c] = (int32_t)phi; a.o_pr[c] = pr; a.o_pj[c] = pj; a.o_prev_waveout[c] = prev;
    a.o_lp_xr[c] = xr0; a.o_lp_xr[Cs + c] = xr1; a.o_lp_xr[2 * Cs + c] = xr2;
    a.o_lp_xi[c] = xi0; a.o_lp_xi[Cs + c] = xi1; a.o_lp_xi[2 * Cs + c] = xi2;
    a.o_lp_yr[c] = yr0; a.o_lp_yr[Cs + c] = yr1; a.o_lp_yr[2 * Cs + c] = yr2;
    a.o_lp_yi[c] = yi0; a.o_lp_yi[Cs + c] = yi1; a.o_lp_yi[2 * Cs + c] = yi2;
    a.o_notch_x[c] = nx0; a.o_notch_x[Cs + c] = nx1; a.o_notch_x[2 * Cs + c] = nx2;
    a.o_notch_y[c] = ny0; a.o_notch_y[Cs + c] = ny1; a.o_notch_y[2 * Cs + c] = ny2;
    if (!ctcss_en) {  // banks that never step, carried through, each group loaded before it is stored
      const int32_t ints[6] = {a.s_fast_count[c], a.s_fast_found[c], a.s_fast_not_found[c],
                               a.s_slow_count[c], a.s_slow_found[c], a.s_slow_not_found[c]};
      const uint8_t bools[4] = {a.s_fast_enough[c], a.s_fast_has_tone[c], a.s_slow_enough[c], a.s_slow_has_tone[c]};
      a.o_fast_count[c] = ints[0]; a.o_fast_found[c] = ints[1]; a.o_fast_not_found[c] = ints[2];
      a.o_slow_count[c] = ints[3]; a.o_slow_found[c] = ints[4]; a.o_slow_not_found[c] = ints[5];
      a.o_fast_enough[c] = bools[0]; a.o_fast_has_tone[c] = bools[1];
      a.o_slow_enough[c] = bools[2]; a.o_slow_has_tone[c] = bools[3];
      carry_rows<MAX_TONES>(a.o_fast_q1, a.s_fast_q1, Cs, c);
      carry_rows<MAX_TONES>(a.o_fast_q2, a.s_fast_q2, Cs, c);
      carry_rows<MAX_TONES>(a.o_slow_q1, a.s_slow_q1, Cs, c);
      carry_rows<MAX_TONES>(a.o_slow_q2, a.s_slow_q2, Cs, c);
    }
    // un-rotate the rings into row-0-oldest order
    for (int k = 0, p = pos_sq; k < SQ_BUF; ++k, p = (p + 1 == SQ_BUF) ? 0 : p + 1) a.o_sq_buffer[k * Cs + c] = sq[p * S];
    for (int k = 0, p = pos_dl; k < AGC_EXTRA; ++k, p = (p + 1 == AGC_EXTRA) ? 0 : p + 1) a.o_wavein_delay[k * Cs + c] = dl[p * S];
  }
};

// Channel c through the W samples of the block, U samples a loop trip (U =
// 1, 2 or 4; U > 1 only cuts the loop's own instructions, each sample still
// waits on the one before; a remainder of W % U samples runs after the
// unrolled trips).  `col` says where its rings live;
// `src.at(n, s, r, i)` gives sample n's magnitude and IQ pair (row n of
// iq_tail below AGC_EXTRA, of iqs above).  The loop runs the step body on
// locals copied from the Channel, not through Channel::step (see
// demod_step_body.cuh).
template <int U, class Src>
DEMOD_HD void demod_channel(const DemodArgs& a, int c0, const float* sin_lut, const float* cos_lut, const Column& col0,
                            Src& src) {
  static_assert(U == 1 || U == 2 || U == 4, "the sample loop takes U = 1, 2 or 4");
  Channel ch;
  ch.load(a, c0, col0);
#define DEMOD_LOCAL(T, name) T name = ch.name;
  DEMOD_CHANNEL_VARS(DEMOD_LOCAL)
#undef DEMOD_LOCAL
  const int W = a.W;
  if constexpr (U == 1) {
#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
    for (int n = 0; n < W; ++n) {
#include "demod_step_body.cuh"
    }
  } else {
    int n0 = 0;
#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
    for (; n0 <= W - U; n0 += U) {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
      for (int u = 0; u < U; ++u) {
        const int n = n0 + u;
#include "demod_step_body.cuh"
      }
    }
#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
    for (int n = n0; n < W; ++n) {
#include "demod_step_body.cuh"
    }
  }
#define DEMOD_BACK(T, name) ch.name = name;
  DEMOD_CHANNEL_VARS(DEMOD_BACK)
#undef DEMOD_BACK
  ch.store(a);
}

// A source that hands over one sample already taken (the pair schedule
// takes both channels' samples together, then steps each channel).
struct Taken {
  float s, r, i;
  DEMOD_HD void at(int, float& s_, float& r_, float& i_) const {
    s_ = s;
    r_ = r;
    i_ = i;
  }
};

// Channels cA and cB stepped together, sample by sample: both samples
// taken (`src.at(n, ...)`), then A's step, then B's.  Two independent
// dependency chains in one loop trip for the compiler's scheduler to
// interleave: the counterpart of the JAX kernel's pair mode, which traces
// two channel tiles' steps into one loop body.  U samples a loop trip, as in
// demod_channel.
template <int U, class PairSrc>
DEMOD_HD void demod_pair(const DemodArgs& a, int cA, int cB, const float* sin_lut, const float* cos_lut,
                         const Column& colA, const Column& colB, PairSrc& src) {
  static_assert(U == 1 || U == 2 || U == 4, "the sample loop takes U = 1, 2 or 4");
  Channel A, B;
  A.load(a, cA, colA);
  B.load(a, cB, colB);
  auto both = [&](int n) {
    Taken ta, tb;
    src.at(n, ta.s, ta.r, ta.i, tb.s, tb.r, tb.i);
    A.step(a, sin_lut, cos_lut, n, ta);
    B.step(a, sin_lut, cos_lut, n, tb);
  };
  const int W = a.W;
  int n0 = 0;
#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
  for (; n0 <= W - U; n0 += U) {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int u = 0; u < U; ++u) both(n0 + u);
  }
#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
  for (int n = n0; n < W; ++n) both(n);
  A.store(a);
  B.store(a);
}

}  // namespace demod
