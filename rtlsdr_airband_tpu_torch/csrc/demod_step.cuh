// Per-channel demod recurrence shared by the CUDA kernel (demod.cu) and a
// host build of the same code (demod_host.cpp, for the CPU tests).
//
// demod_channel() advances ONE channel through the W samples of a block:
// the reference's whole per-sample loop (src/rtl_airband.cpp:495-648 with
// squelch.cpp, ctcss.cpp and filters.cpp).  It is the operation-for-operation
// transcription of the plain PyTorch version, ops/demod.py::_scan_step:
// every float operation is written in the same order, so that with
// contraction to fused multiply-add turned off (nvcc --fmad=false,
// g++ -ffp-contract=off) each one rounds as the plain version's does and
// every output and every state leaf comes out equal, bit for bit.
//
// Layout: every per-channel array of the arguments is [rows, C] with the
// channel fastest, so the threads of a warp (consecutive channels) touch
// consecutive addresses.  Where the step keeps its rings, Goertzel banks and
// tone tables (a Column) and where it takes each sample from (a source) are
// the caller's: demod_tiles.cuh holds the two designs, the kernel's shared-
// memory tiles and the first design's device-memory rows.

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
  /* outputs: audio before fade assembly [W, C]; flags [W, C] (bit 0 open,            \
     bit 1 AM fade); gated IQ [W, C, 2], only written when with_iq */                  \
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

struct Bank {
  int32_t count, found, not_found;
  bool enough, has_tone;
};

// Where one channel's rings, Goertzel banks and tone tables live: pointers
// at its row 0, consecutive rows `stride` elements apart.  Rows of the
// rings hold the rotating ring (slot n % rows); the banks are [MAX_TONES].
struct Column {
  float *sq, *dl;                // squelch ring [SQ_BUF], wavein delay line [AGC_EXTRA]
  float *fq1, *fq2, *sq1, *sq2;  // fast / slow Goertzel accumulators
  const float *fcoeff, *scoeff;  // fast / slow tone coefficients
  const uint8_t *fmask, *smask;  // fast / slow tone masks
  size_t stride;
};

// One Goertzel-bank sample (ctcss.cpp:44-61,124-163).  q1/q2/coeff/mask
// point at this channel's tone 0; tone t is t*S further on.  Rare code
// (reset, decision) stays a loop: it runs once a window.
DEMOD_HD void bank_step(float* __restrict__ q1, float* __restrict__ q2, const float* __restrict__ coeff,
                        const uint8_t* __restrict__ mask, size_t S, int32_t window, float ntones, float sample,
                        bool advance, bool reset, Bank& b) {
  if (reset) {
#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
    for (int t = 0; t < MAX_TONES; ++t) {
      q1[t * S] = 0.0f;
      q2[t * S] = 0.0f;
    }
    b.count = 0;
    b.enough = false;
    b.has_tone = false;
  }
  if (!advance) return;
  // unrolled whole: the 52 tones are independent, so every load issues
  // before the first one's result is needed (unrolled by 4, each trip of 4
  // tones waited out a shared-memory latency; PERF.md, section 6)
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int t = 0; t < MAX_TONES; ++t) {
    const float a = q1[t * S], z = q2[t * S];
    q2[t * S] = a;
    q1[t * S] = coeff[t * S] * a - z + sample;
  }
  b.count += 1;
  if (b.count < window) return;
  // window complete: max + average decision, then restart the window
  float maxp = -INFINITY, total = 0.0f, p0 = 0.0f;
#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
  for (int t = 0; t < MAX_TONES; ++t) {
    const float x = q1[t * S], y = q2[t * S];
    const float power = x * x + y * y - x * y * coeff[t * S];
    if (t == 0) p0 = power;
    const bool m = mask[t * S] != 0;
    if (m && (power != power || power > maxp)) maxp = power;  // NaN propagates, as amax does
    total = total + (m ? power : 0.0f);
    q1[t * S] = 0.0f;
    q2[t * S] = 0.0f;
  }
  const float avg = total / ntones;
  const bool detected = (p0 == maxp) && (p0 > avg);
  b.has_tone = detected;
  b.enough = true;
  b.found += detected ? 1 : 0;
  b.not_found += detected ? 0 : 1;
  b.count = 0;
}

// Channel c through the W samples of the block.  `col` says where its rings,
// banks and tone tables live; `src.at(n, s, r, i)` gives sample n's
// magnitude and IQ pair (row n of iq_tail below AGC_EXTRA, of iqs above).
template <class Src>
DEMOD_HD void demod_channel(const DemodArgs& a, int c, const float* sin_lut, const float* cos_lut, const Column& col,
                            Src& src) {
  const int W = a.W;
  const size_t Cs = (size_t)a.C;
  const size_t S = col.stride;

  // ---- loop-invariant params ----
  const bool is_nfm = a.p_is_nfm[c] != 0;
  const bool is_am = !is_nfm;
  const bool needs_iq = a.p_needs_raw_iq[c] != 0;
  const bool iq_outs = a.p_has_iq_outputs[c] != 0;
  const uint32_t dphi = (uint32_t)a.p_dm_dphi[c];
  const float alpha = a.p_alpha[c], amp = a.p_ampfactor[c];
  const bool useman = a.p_using_manual[c] != 0;
  const float manual = a.p_manual_level[c], nratio = a.p_normal_ratio[c], fratio = a.p_flappy_ratio[c];
  const bool lp_en = a.p_lp_enabled[c] != 0;
  const float lp_gain = a.p_lp_gain[c], lp_y0 = a.p_lp_y0[c], lp_y1 = a.p_lp_y1[c];
  const bool notch_en = a.p_notch_enabled[c] != 0;
  const float nd0 = a.p_notch_d0[c], nd1 = a.p_notch_d1[c], nd2 = a.p_notch_d2[c];
  const bool ctcss_en = a.p_ctcss_enabled[c] != 0;
  const int32_t fwin = a.p_fast_window[c], swin = a.p_slow_window[c];
  const float fnt = a.p_fast_ntones[c], snt = a.p_slow_ntones[c];

  // ---- scalar state into registers ----
  float nf = a.s_noise_floor[c], pre_full = a.s_pre_full[c], pre_capped = a.s_pre_capped[c];
  float post_full = a.s_post_full[c], post_capped = a.s_post_capped[c];
  bool upf = a.s_using_post_filter[c] != 0;
  int32_t cur = a.s_cur[c], nxt = a.s_nxt[c], delay = a.s_delay[c], lsc = a.s_low_signal_count[c];
  int32_t sample_count = a.s_sample_count[c], open_count = a.s_open_count[c];
  int32_t flappy = a.s_flappy_count[c], roc = a.s_recent_open_count[c], csc = a.s_closed_sample_count[c];
  float agc = a.s_agc[c], pr = a.s_pr[c], pj = a.s_pj[c], prev = a.s_prev_waveout[c];
  uint32_t phi = (uint32_t)a.s_dm_phi[c];
  float xr0 = a.s_lp_xr[c], xr1 = a.s_lp_xr[Cs + c], xr2 = a.s_lp_xr[2 * Cs + c];
  float xi0 = a.s_lp_xi[c], xi1 = a.s_lp_xi[Cs + c], xi2 = a.s_lp_xi[2 * Cs + c];
  float yr0 = a.s_lp_yr[c], yr1 = a.s_lp_yr[Cs + c], yr2 = a.s_lp_yr[2 * Cs + c];
  float yi0 = a.s_lp_yi[c], yi1 = a.s_lp_yi[Cs + c], yi2 = a.s_lp_yi[2 * Cs + c];
  float nx0 = a.s_notch_x[c], nx1 = a.s_notch_x[Cs + c], nx2 = a.s_notch_x[2 * Cs + c];
  float ny0 = a.s_notch_y[c], ny1 = a.s_notch_y[Cs + c], ny2 = a.s_notch_y[2 * Cs + c];
  Bank fast{a.s_fast_count[c], a.s_fast_found[c], a.s_fast_not_found[c], a.s_fast_enough[c] != 0, a.s_fast_has_tone[c] != 0};
  Bank slow{a.s_slow_count[c], a.s_slow_found[c], a.s_slow_not_found[c], a.s_slow_enough[c] != 0, a.s_slow_has_tone[c] != 0};

  // ---- rings and banks into their column, row 0 oldest ----
  float* sq = col.sq;
  float* dl = col.dl;
  for (int k = 0; k < SQ_BUF; ++k) sq[k * S] = a.s_sq_buffer[k * Cs + c];
  for (int k = 0; k < AGC_EXTRA; ++k) dl[k * S] = a.s_wavein_delay[k * Cs + c];
  for (int t = 0; t < MAX_TONES; ++t) {
    col.fq1[t * S] = a.s_fast_q1[t * Cs + c];
    col.fq2[t * S] = a.s_fast_q2[t * Cs + c];
    col.sq1[t * S] = a.s_slow_q1[t * Cs + c];
    col.sq2[t * S] = a.s_slow_q2[t * Cs + c];
  }

  // rotating ring positions: slot pos_sq holds the oldest entry (n % SQ_BUF)
  int pos_sq = 0, pos_dl = 0;
#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
  for (int n = 0; n < W; ++n) {
    const int pos_sq1 = (pos_sq + 1 == SQ_BUF) ? 0 : pos_sq + 1;
    // loads that depend on no arithmetic of this step, issued together
    float s, in_r, in_i;
    src.at(n, s, in_r, in_i);
    const float buf_old = sq[pos_sq * S];   // age-102 value (pre-append)
    const float buf_tail = sq[pos_sq1 * S]; // age-101 value (oldest after the append)
    const float env = dl[pos_dl * S];       // wavein[j - AGC_EXTRA]

    // ======== Squelch::update_current_state (squelch.cpp:363-460) ========
    const bool is_A = nxt == OPENING, A1 = is_A && cur != OPENING, A2 = is_A && !A1;
    const bool is_B = nxt == CLOSING, B1 = is_B && cur != CLOSING, B2 = is_B && !B1;
    const bool is_C = nxt == LSA, C1 = is_C && cur != LSA, C2 = is_C && !C1;
    const bool is_D = nxt == OPEN && cur != OPEN;
    const bool is_E = nxt == CLOSED && cur != CLOSED;
    const bool is_F = nxt == CLOSED && cur == CLOSED;
    const bool is_else = nxt == OPEN && cur == OPEN;

    const int32_t delay1 = (A1 || B1 || (C1 && cur != CLOSING)) ? 0 : ((A2 || B2 || C2) ? delay + 1 : delay);
    const bool a2_fire = A2 && delay1 >= OPEN_DELAY;
    const bool a2_count = a2_fire && csc < RECENT_SAMPLE_SIZE;
    int32_t roc1 = roc + (a2_count ? 1 : 0);
    const int32_t flappy1 = flappy + ((a2_count && roc1 >= FLAP_OPENS_THRESHOLD) ? 1 : 0);

    const bool hasA = (pre_capped >= levels(useman, manual, nratio, fratio, nf, roc1)) && (!upf || post_capped >= buf_old);
    const bool hasB = (pre_capped >= levels(useman, manual, nratio, fratio, nf, roc)) && (!upf || post_capped >= buf_old);
    const bool b2_fire = B2 && delay1 >= CLOSE_DELAY;
    const bool c2_fire = C2 && delay1 >= CLOSE_DELAY;

    int32_t cur1 = cur;
    if (A1) cur1 = OPENING;
    if (B1) cur1 = CLOSING;
    if (b2_fire && hasB) cur1 = OPEN;  // revert to OPEN w/o open_count++
    if (C1) cur1 = LSA;
    if (is_D) cur1 = OPEN;
    if (is_E) cur1 = CLOSED;
    if (is_else) cur1 = nxt;

    int32_t nxt1 = nxt;
    if (a2_fire) nxt1 = hasA ? OPEN : CLOSED;
    if (b2_fire) nxt1 = hasB ? OPEN : CLOSED;
    if (c2_fire) nxt1 = CLOSED;

    const int32_t lsc1 = A1 ? 0 : lsc;
    const bool upf1 = upf && !(A1 || is_E);
    const int32_t open_count1 = open_count + (is_D ? 1 : 0);
    if (is_F && csc == RECENT_SAMPLE_SIZE) roc1 = 0;
    int32_t csc1 = is_E ? 0 : csc;
    if (is_F && csc < RECENT_SAMPLE_SIZE) csc1 = csc + 1;
    const bool ctcss_reset = is_E && ctcss_en;

    // ======== process_raw_sample rest (squelch.cpp:196-246) ========
    const int32_t sample_count1 = (int32_t)((uint32_t)sample_count + 1u);
    const bool do_nf = (sample_count1 & 15) == 0;
    const float nf1 = do_nf ? nf * NF_DECAY + min_nan(pre_capped, nf) * NF_NEW + NF_BIAS : nf;
    const float cap = 1.5f * (useman ? manual : nratio * nf1);

    const float pre_full1 = pre_full * MA_DECAY + s * MA_NEW;
    const float pre_capped1 = (pre_capped >= cap && s >= cap) ? cap : min_nan(cap, pre_capped * MA_DECAY + s * MA_NEW);
    sq[pos_sq * S] = pre_capped1 * PRE_VS_POST;  // append (overwrites the oldest)

    const float lvl1 = levels(useman, manual, nratio, fratio, nf1, roc1);
    const bool has_pre = pre_capped1 >= lvl1;
    const bool has_sig = has_pre && (!upf1 || post_capped >= buf_tail);

    int32_t nxt2 = nxt1;
    if (cur1 == OPEN && !has_sig) nxt2 = set_state_valid(cur1, CLOSING);
    if (cur1 == CLOSED && has_sig) nxt2 = set_state_valid(cur1, OPENING);

    const bool active = cur1 != CLOSED && cur1 != LSA;
    const bool below = s < lvl1;
    const int32_t lsc2 = active ? (below ? lsc1 + 1 : 0) : lsc1;
    const bool lsa_fire = active && below && lsc2 >= LOW_SIGNAL_ABORT;
    const int32_t nxt3 = lsa_fire ? set_state_valid(cur1, LSA) : nxt2;

    // ======== filtering path (rtl_airband.cpp:507-529) ========
    const bool should_filter = (has_pre || cur1 != CLOSED) && cur1 != LSA;
    const bool do_filter = should_filter && needs_iq;

    // derotation: interpolated 256-entry LUT (util.cpp:113-127)
    const uint32_t idx = phi >> 16;
    const float fract = (float)(phi & 0xFFFFu) * (1.0f / 65536.0f);
    const float s1 = sin_lut[idx], s2 = sin_lut[idx + 1];
    const float c1 = cos_lut[idx], c2 = cos_lut[idx + 1];
    const float swf = s1 + (s2 - s1) * fract;
    const float cwf = c1 + (c2 - c1) * fract;
    const float re_d = in_r * cwf + in_i * swf;
    const float im_d = in_i * cwf - in_r * swf;
    if (do_filter) phi = (phi + dphi) & 0xFFFFFFu;

    // complex Bessel lowpass biquad (filters.cpp:158-180)
    const bool adv_lp = do_filter && lp_en;
    const float x2r = re_d / lp_gain;
    const float x2i = im_d / lp_gain;
    if (adv_lp) {
      xr0 = xr1; xr1 = xr2; xr2 = x2r;
      xi0 = xi1; xi1 = xi2; xi2 = x2i;
    }
    const float y2r = (xr0 + xr2) + 2.0f * xr1 + lp_y0 * yr1 + lp_y1 * yr2;
    const float y2i = (xi0 + xi2) + 2.0f * xi1 + lp_y0 * yi1 + lp_y1 * yi2;
    if (adv_lp) {
      yr0 = yr1; yr1 = yr2; yr2 = y2r;
      yi0 = yi1; yi1 = yi2; yi2 = y2i;
    }
    const float real = do_filter ? (lp_en ? y2r : re_d) : in_r;
    const float imag = do_filter ? (lp_en ? y2i : im_d) : in_i;
    const float wavein_mod = do_filter ? sqrtf(real * real + imag * imag) : s;

    // process_filtered_sample (squelch.cpp:248-276)
    const bool pf = do_filter && lp_en;
    const bool opening = cur1 == OPENING;
    const bool skip = pf && opening && delay1 < SQ_BUF;
    const bool init_pf = pf && opening && delay1 == SQ_BUF;
    const float post_full_b = init_pf ? buf_tail : post_full;
    const float post_capped_b = init_pf ? buf_tail : post_capped;
    const bool eff = pf && !skip;
    const bool upf2 = upf1 || eff;
    const float post_full1 = eff ? post_full_b * MA_DECAY + wavein_mod * MA_NEW : post_full_b;
    const float post_capped1 =
        eff ? ((post_capped_b >= cap && wavein_mod >= cap) ? cap : min_nan(cap, post_capped_b * MA_DECAY + wavein_mod * MA_NEW))
            : post_capped_b;
    const bool close_fire = eff && post_capped1 < buf_tail;
    const int32_t nxt4 = close_fire ? set_state_valid(cur1, CLOSED) : nxt3;

    // ======== demod (rtl_airband.cpp:532-618) ========
    const bool first_open = cur1 != OPEN && nxt4 == OPEN;
    const bool last_open = (cur1 == CLOSING && nxt4 == CLOSED) || (cur1 != LSA && nxt4 == LSA);
    const bool spa = cur1 == OPEN || cur1 == CLOSING;

    float waveout, agc2;
    if (is_am) {
      float agc1 = agc;
      if (first_open) {
        // squelch-open AGC bootstrap: sequential fold, oldest first
        int p = pos_dl;
#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
        for (int i = 0; i < AGC_EXTRA; ++i) {
          const float v = dl[p * S];
          if (v >= lvl1) agc1 = 0.9f * agc1 + 0.1f * v;
          p = (p + 1 == AGC_EXTRA) ? 0 : p + 1;
        }
      }
      // envelope demod + AGC (rtl_airband.cpp:548-562)
      float agc_am = (spa && wavein_mod > lvl1) ? agc1 * 0.995f + wavein_mod * 0.005f : agc1;
      float w_am = (env - agc_am) / (agc_am * 1.5f);
      const bool over = fabsf(w_am) > 0.8f;
      if (over) w_am = w_am * 0.85f;
      if (spa && over) agc_am = agc_am * 1.15f;
      waveout = w_am;
      agc2 = spa ? agc_am : agc1;
    } else {
      // discriminator + DC block + de-emphasis (rtl_airband.cpp:564-582)
      float disc;
      if (a.fm_quadri) {
        disc = (pr * imag - real * pj) / (real * real + imag * imag + 1.0f) * M1PI;
      } else {
        const float cr = real * pr + imag * pj;
        const float cj = imag * pr - real * pj;
        disc = fast_atan2(cj, cr) * M1PI;
      }
      const float agc_nfm = agc * 0.995f + disc * 0.005f;
      float w_n = disc - agc_nfm;
      w_n = w_n * (1.0f - alpha) + prev * alpha;
      if (spa) {
        pr = real;
        pj = imag;
        prev = w_n;
      }
      waveout = w_n;
      agc2 = spa ? agc_nfm : agc;
    }
    dl[pos_dl * S] = wavein_mod;  // append after the env / bootstrap reads

    // ======== CTCSS (squelch.cpp:278-292, ctcss.cpp) ========
    bool gate = true;
    if (a.with_ctcss) {
      const bool adv_ct = spa && cur1 != CLOSED && ctcss_en;
      if (adv_ct || ctcss_reset) {
        bank_step(col.sq1, col.sq2, col.scoeff, col.smask, S, swin, snt, waveout, adv_ct, ctcss_reset, slow);
        bank_step(col.fq1, col.fq2, col.fcoeff, col.fmask, S, fwin, fnt, waveout, adv_ct && !slow.enough,
                  ctcss_reset, fast);
      }
      if (ctcss_en) gate = slow.enough ? slow.has_tone : fast.has_tone;
    }
    const bool open_now = spa && gate;

    // ======== notch + ampfactor + clamp (rtl_airband.cpp:590-618) ========
    if (open_now && notch_en) {
      nx0 = nx1; nx1 = nx2; nx2 = waveout;
    }
    const float nyn = nd0 * nx2 - nd1 * nx1 + nd0 * nx0 + nd1 * ny2 - nd2 * ny1;
    if (open_now && notch_en) {
      ny0 = ny1; ny1 = ny2; ny2 = nyn;
    }
    const float w4 = (notch_en ? nyn : waveout) * amp;
    const float w5 = (w4 != w4) ? 0.0f : fminf(fmaxf(w4, -1.0f), 1.0f);

    const size_t o = (size_t)n * Cs + c;
    a.audio_raw[o] = open_now ? w5 : 0.0f;
    a.flags[o] = (uint8_t)((open_now ? 1 : 0) | ((last_open && is_am) ? 2 : 0));
    if (a.with_iq) {
      const bool g = open_now && iq_outs;
      a.iq_out[2 * o] = g ? real : 0.0f;
      a.iq_out[2 * o + 1] = g ? imag : 0.0f;
    }

    // ---- state update ----
    nf = nf1; pre_full = pre_full1; pre_capped = pre_capped1;
    post_full = post_full1; post_capped = post_capped1; upf = upf2;
    cur = cur1; nxt = nxt4; delay = delay1; lsc = lsc2; sample_count = sample_count1;
    open_count = open_count1; flappy = flappy1; roc = roc1; csc = csc1; agc = agc2;
    pos_sq = pos_sq1;
    pos_dl = (pos_dl + 1 == AGC_EXTRA) ? 0 : pos_dl + 1;
  }

  // ---- state out ----
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
  a.o_fast_count[c] = fast.count; a.o_fast_found[c] = fast.found; a.o_fast_not_found[c] = fast.not_found;
  a.o_fast_enough[c] = fast.enough ? 1 : 0; a.o_fast_has_tone[c] = fast.has_tone ? 1 : 0;
  a.o_slow_count[c] = slow.count; a.o_slow_found[c] = slow.found; a.o_slow_not_found[c] = slow.not_found;
  a.o_slow_enough[c] = slow.enough ? 1 : 0; a.o_slow_has_tone[c] = slow.has_tone ? 1 : 0;
  for (int t = 0; t < MAX_TONES; ++t) {
    a.o_fast_q1[t * Cs + c] = col.fq1[t * S];
    a.o_fast_q2[t * Cs + c] = col.fq2[t * S];
    a.o_slow_q1[t * Cs + c] = col.sq1[t * S];
    a.o_slow_q2[t * Cs + c] = col.sq2[t * S];
  }
  // un-rotate the rings into row-0-oldest order
  for (int k = 0; k < SQ_BUF; ++k) {
    a.o_sq_buffer[k * Cs + c] = sq[pos_sq * S];
    pos_sq = (pos_sq + 1 == SQ_BUF) ? 0 : pos_sq + 1;
  }
  for (int k = 0; k < AGC_EXTRA; ++k) {
    a.o_wavein_delay[k * Cs + c] = dl[pos_dl * S];
    pos_dl = (pos_dl + 1 == AGC_EXTRA) ? 0 : pos_dl + 1;
  }
}

}  // namespace demod
