// The demod step of one channel at sample n: the body of the sample loop,
// included where the loop runs (demod_step.cuh: demod_channel on locals,
// Channel::step on a Channel's members).  It reads and writes the names of
// DEMOD_CHANNEL_VARS, `a`, `n`, `src`, `sin_lut` and `cos_lut`.  One text
// for both: nvcc compiles it to the same SASS as the loop body it was only
// where it runs on locals (as a function on a struct's members the step
// took 24 more SASS instructions and 4 % more time on the card, PERF.md
// section 6), so the default schedule keeps it inline.
//
// No include guard: it is included inside each loop that runs it, not at
// the top of a file.

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

    // ======== CTCSS (squelch.cpp:278-292, ctcss.cpp): the CTCSS pass ========
    // A CTCSS channel's banks, its gate and what the gate feeds run in the
    // pass after K1 (demod_ctcss.cuh).  Here such a channel's audio holds
    // waveout where the squelch is open (before the notch and ampfactor), and
    // its flag byte what the pass reads (demod::flag): spa in OPEN, the AM
    // close mark, adv_ct (the banks step) in ADVANCE and ctcss_reset in
    // RESET.  Every other channel's gate is open, and its outputs are final
    // here.
    const bool adv_ct = spa && cur1 != CLOSED && ctcss_en;
    const bool open_now = spa;

    // ======== notch + ampfactor + clamp (rtl_airband.cpp:590-618) ========
    const bool adv_notch = open_now && notch_en && !ctcss_en;
    if (adv_notch) {
      nx0 = nx1; nx1 = nx2; nx2 = waveout;
    }
    const float nyn = nd0 * nx2 - nd1 * nx1 + nd0 * nx0 + nd1 * ny2 - nd2 * ny1;
    if (adv_notch) {
      ny0 = ny1; ny1 = ny2; ny2 = nyn;
    }
    const float w4 = (notch_en ? nyn : waveout) * amp;
    const float w5 = (w4 != w4) ? 0.0f : fminf(fmaxf(w4, -1.0f), 1.0f);

    const size_t o = (size_t)n * Cs + c;
    a.audio_raw[o] = open_now ? (ctcss_en ? waveout : w5) : 0.0f;
    a.flags[o] = (uint8_t)((open_now ? flag::OPEN : 0u) | ((last_open && is_am) ? flag::CLOSE_MARK : 0u) |
                            (adv_ct ? flag::ADVANCE : 0u) | (ctcss_reset ? flag::RESET : 0u));
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
