"""Per-sample demodulation: state types and the plain PyTorch version.

Counterpart of ``rtlsdr_airband_tpu/ops/demod.py``.  ``demod_block`` here
is the plain PyTorch version of the demod recurrence (reference:
src/rtl_airband.cpp:495-648 plus squelch.cpp, ctcss.cpp and filters.cpp):
a Python loop over the W samples of a block, each step a handful of
elementwise ops vectorized over the C channels.  It is the oracle for the
CUDA kernel in ``csrc/demod.cu`` and the path ``demod_block_cuda`` takes for
tensors on the CPU.

Notes on the arithmetic, which the kernel repeats operation for operation:
 - every op is a single elementwise torch op (no fused multiply-add), and
   scalars are float32 values, so each rounding matches the kernel's;
 - masked ``where`` updates: state only advances where the reference would
   have executed the branch;
 - the rings use shift-append form, so row 0 is always the oldest;
 - the AM squelch-open AGC bootstrap is the reference's sequential fold
   over the 100-sample look-back, as in the kernel (the JAX package's XLA
   scan takes a closed form, which agrees to float rounding);
 - the CTCSS window decision sums the tone powers in tone order, and the
   Goertzel bank, the bootstrap and the decision run only on steps where
   some channel needs them (skipped steps would not change any value).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..constants import AGC_EXTRA

# Squelch states (reference: squelch.h:104-110)
CLOSED, OPENING, CLOSING, LSA, OPEN = 0, 1, 2, 3, 4

# Hardcoded squelch parameters (reference: squelch.cpp:49-70)
OPEN_DELAY = 197
CLOSE_DELAY = 197
LOW_SIGNAL_ABORT = 88
RECENT_SAMPLE_SIZE = 1000
FLAP_OPENS_THRESHOLD = 3
SQ_BUF = 102


def _f32(v) -> float:
    """A Python float holding exactly the float32 value of ``v``."""
    return float(np.float32(v))


PRE_VS_POST = _f32(0.9)
MA_DECAY = _f32(0.99)
MA_NEW = _f32(np.float32(1.0) - np.float32(0.99))
NF_DECAY = _f32(0.97)
NF_NEW = _f32(np.float32(1.0) - np.float32(0.97))
NF_BIAS = _f32(1e-6)

_PI4 = _f32(np.pi / 4)
_PI34 = _f32(3 * np.pi / 4)
_M1PI = _f32(1.0 / np.pi)

# AM squelch-close fade-out factors 0.94^i, i = 0..AGC_EXTRA-1
# (rtl_airband.cpp:542-546), in float32 as the JAX package builds them
FADE_DECAY = np.power(np.float32(0.94), np.arange(AGC_EXTRA, dtype=np.float32))


@functools.cache
def _fade_decay(device: torch.device) -> torch.Tensor:
    """FADE_DECAY on ``device``, copied there once: a copy from the host
    every block would make the host wait for the device's queue."""
    return torch.as_tensor(FADE_DECAY, device=device)


class ChannelParams(NamedTuple):
    """Static per-channel parameters, all [C] (or [T, C]) tensors."""

    is_nfm: torch.Tensor  # bool
    needs_raw_iq: torch.Tensor  # bool
    has_iq_outputs: torch.Tensor  # bool
    dm_dphi: torch.Tensor  # int32 (< 2^24)
    alpha: torch.Tensor  # f32 (NFM de-emphasis)
    ampfactor: torch.Tensor  # f32
    # squelch config
    using_manual: torch.Tensor  # bool
    manual_level: torch.Tensor  # f32
    normal_ratio: torch.Tensor  # f32
    flappy_ratio: torch.Tensor  # f32
    # lowpass (complex Bessel biquad)
    lp_enabled: torch.Tensor  # bool
    lp_gain: torch.Tensor  # f32
    lp_y0: torch.Tensor  # f32
    lp_y1: torch.Tensor  # f32
    # notch biquad
    notch_enabled: torch.Tensor  # bool
    notch_d0: torch.Tensor
    notch_d1: torch.Tensor
    notch_d2: torch.Tensor
    # CTCSS banks [T, C]
    ctcss_enabled: torch.Tensor  # bool [C]
    fast_coeff: torch.Tensor  # f32 [T, C]
    fast_mask: torch.Tensor  # bool [T, C]
    fast_window: torch.Tensor  # i32 [C]
    fast_ntones: torch.Tensor  # f32 [C]
    slow_coeff: torch.Tensor
    slow_mask: torch.Tensor
    slow_window: torch.Tensor
    slow_ntones: torch.Tensor
    # sincos LUT (shared)
    sin_lut: torch.Tensor  # [257]
    cos_lut: torch.Tensor  # [257]


class CtcssState(NamedTuple):
    q1: torch.Tensor  # f32 [T, C]
    q2: torch.Tensor  # f32 [T, C]
    count: torch.Tensor  # i32 [C]
    enough: torch.Tensor  # bool [C]
    has_tone: torch.Tensor  # bool [C]
    found: torch.Tensor  # i32 [C]
    not_found: torch.Tensor  # i32 [C]


class DemodState(NamedTuple):
    """Carried state, threaded between blocks.  Field names, shapes and row
    order are the JAX package's; ``dm_phi`` is int32 here (uint32 there)."""

    # squelch
    noise_floor: torch.Tensor
    pre_full: torch.Tensor
    pre_capped: torch.Tensor
    post_full: torch.Tensor
    post_capped: torch.Tensor
    using_post_filter: torch.Tensor  # bool
    cur: torch.Tensor  # i32
    nxt: torch.Tensor  # i32
    delay: torch.Tensor  # i32
    low_signal_count: torch.Tensor  # i32
    sample_count: torch.Tensor  # i32
    open_count: torch.Tensor
    flappy_count: torch.Tensor
    recent_open_count: torch.Tensor
    closed_sample_count: torch.Tensor
    sq_buffer: torch.Tensor  # f32 [SQ_BUF, C], row 0 oldest
    # filters
    lp_xr: torch.Tensor  # f32 [3, C]
    lp_xi: torch.Tensor
    lp_yr: torch.Tensor
    lp_yi: torch.Tensor
    notch_x: torch.Tensor  # f32 [3, C]
    notch_y: torch.Tensor
    # demod
    agc: torch.Tensor  # f32 (agcavgfast)
    dm_phi: torch.Tensor  # int32
    pr: torch.Tensor
    pj: torch.Tensor
    prev_waveout: torch.Tensor
    # ctcss
    fast: CtcssState
    slow: CtcssState
    # block-carry delay lines
    wavein_delay: torch.Tensor  # f32 [AGC_EXTRA, C], row 0 oldest (modified wavein)
    iq_tail: torch.Tensor  # f32 [AGC_EXTRA, C, 2] unconsumed channelizer IQ
    waveout_tail: torch.Tensor  # f32 [AGC_EXTRA, C]


def _levels(p: ChannelParams, nf, roc):
    """Eager squelch_level() (reference: squelch.cpp:169-177)."""
    flapping = roc >= FLAP_OPENS_THRESHOLD
    ratio = torch.where(flapping & (p.flappy_ratio < p.normal_ratio), p.flappy_ratio, p.normal_ratio)
    return torch.where(p.using_manual, p.manual_level, ratio * nf)


def _set_state_valid(cur, upd):
    """Transition-validity table (reference: squelch.cpp:297-361)."""
    u = upd if isinstance(upd, torch.Tensor) else torch.full_like(cur, upd)
    u = torch.where((cur == CLOSED) & ((u == CLOSING) | (u == LSA)), CLOSED, u)
    u = torch.where((cur == CLOSED) & (u == OPEN), OPENING, u)
    u = torch.where((cur == OPENING) & (u == LSA), CLOSED, u)
    u = torch.where((cur == LSA) & (u != LSA) & (u != CLOSED), CLOSED, u)
    u = torch.where((cur == OPEN) & (u == CLOSED), CLOSING, u)
    u = torch.where((cur == OPEN) & (u == OPENING), OPEN, u)
    return u


def _fast_atan2(y, x):
    """reference: rtl_airband.cpp:147-166."""
    yabs = torch.abs(y)
    pos = x >= 0.0
    angle = torch.where(pos, _PI4 - _PI4 * (x - yabs) / (x + yabs), _PI34 - _PI4 * (x + yabs) / (yabs - x))
    angle = torch.where(y < 0.0, -angle, angle)
    return torch.where((x == 0.0) & (y == 0.0), 0.0, angle)


def _ctcss_bank_step(ct: CtcssState, coeff, mask, window, ntones, sample, advance, reset):
    """One Goertzel-bank sample (reference: ctcss.cpp:44-61,124-163)."""
    q1 = torch.where(reset, 0.0, ct.q1)
    q2 = torch.where(reset, 0.0, ct.q2)
    count = torch.where(reset, 0, ct.count)
    enough = ct.enough & ~reset
    has_tone = ct.has_tone & ~reset

    q0 = coeff * q1 - q2 + sample
    q2n = torch.where(advance, q1, q2)
    q1n = torch.where(advance, q0, q1)
    countn = torch.where(advance, count + 1, count)
    latch = advance & (countn >= window)
    if not bool(latch.any()):
        return CtcssState(q1n, q2n, countn, enough, has_tone, ct.found, ct.not_found)

    power = q1n * q1n + q2n * q2n - q1n * q2n * coeff
    maxp = torch.where(mask, power, -torch.inf).amax(dim=0)
    total = torch.zeros_like(power[0])
    for t in range(power.shape[0]):  # tone order, as the kernel sums
        total = total + torch.where(mask[t], power[t], 0.0)
    avg = total / ntones
    detected = (power[0] == maxp) & (power[0] > avg)

    has_tone2 = torch.where(latch, detected, has_tone)
    found2 = ct.found + (latch & detected).to(torch.int32)
    nfound2 = ct.not_found + (latch & ~detected).to(torch.int32)
    q1f = torch.where(latch, 0.0, q1n)
    q2f = torch.where(latch, 0.0, q2n)
    countf = torch.where(latch, 0, countn)
    return CtcssState(q1f, q2f, countf, enough | latch, has_tone2, found2, nfound2)


def _stack_shift(rows, new, adv):
    """Three-row filter history: drop row 0 and append ``new`` where ``adv``."""
    return torch.where(adv, torch.stack([rows[1], rows[2], new]), rows)


def _scan_step(p: ChannelParams, st: DemodState, s, in_r, in_i, fm_quadri: bool, with_ctcss: bool):
    """One audio sample for every channel; returns (state', outputs)."""
    # ======== Squelch::update_current_state (squelch.cpp:363-460) ========
    cur, nxt = st.cur, st.nxt
    buf_old = st.sq_buffer[0]  # age-102 value (pre-append)

    is_A = nxt == OPENING
    A1 = is_A & (cur != OPENING)
    A2 = is_A & ~A1
    is_B = nxt == CLOSING
    B1 = is_B & (cur != CLOSING)
    B2 = is_B & ~B1
    is_C = nxt == LSA
    C1 = is_C & (cur != LSA)
    C2 = is_C & ~C1
    is_D = (nxt == OPEN) & (cur != OPEN)
    is_E = (nxt == CLOSED) & (cur != CLOSED)
    is_F = (nxt == CLOSED) & (cur == CLOSED)
    is_else = (nxt == OPEN) & (cur == OPEN)

    delay1 = torch.where(A1 | B1 | (C1 & (cur != CLOSING)), 0, torch.where(A2 | B2 | C2, st.delay + 1, st.delay))

    a2_fire = A2 & (delay1 >= OPEN_DELAY)
    a2_count = a2_fire & (st.closed_sample_count < RECENT_SAMPLE_SIZE)
    roc1 = st.recent_open_count + a2_count.to(torch.int32)
    flappy_count1 = st.flappy_count + (a2_count & (roc1 >= FLAP_OPENS_THRESHOLD)).to(torch.int32)

    def hassig(roc):
        lvl = _levels(p, st.noise_floor, roc)
        return (st.pre_capped >= lvl) & (~st.using_post_filter | (st.post_capped >= buf_old))

    hasA = hassig(roc1)
    hasB = hassig(st.recent_open_count)

    b2_fire = B2 & (delay1 >= CLOSE_DELAY)
    c2_fire = C2 & (delay1 >= CLOSE_DELAY)

    cur1 = cur
    cur1 = torch.where(A1, OPENING, cur1)
    cur1 = torch.where(B1, CLOSING, cur1)
    cur1 = torch.where(b2_fire & hasB, OPEN, cur1)  # revert to OPEN w/o open_count++
    cur1 = torch.where(C1, LSA, cur1)
    cur1 = torch.where(is_D, OPEN, cur1)
    cur1 = torch.where(is_E, CLOSED, cur1)
    cur1 = torch.where(is_else, nxt, cur1)

    nxt1 = nxt
    nxt1 = torch.where(a2_fire & hasA, OPEN, torch.where(a2_fire, CLOSED, nxt1))
    nxt1 = torch.where(b2_fire & hasB, OPEN, torch.where(b2_fire, CLOSED, nxt1))
    nxt1 = torch.where(c2_fire, CLOSED, nxt1)

    lsc1 = torch.where(A1, 0, st.low_signal_count)
    upf1 = st.using_post_filter & ~(A1 | is_E)
    open_count1 = st.open_count + is_D.to(torch.int32)
    roc1 = torch.where(is_F & (st.closed_sample_count == RECENT_SAMPLE_SIZE), 0, roc1)
    csc1 = torch.where(is_E, 0, st.closed_sample_count)
    csc1 = torch.where(is_F & (st.closed_sample_count < RECENT_SAMPLE_SIZE), st.closed_sample_count + 1, csc1)
    ctcss_reset = is_E & p.ctcss_enabled

    # ======== process_raw_sample rest (squelch.cpp:196-246) ========
    sample_count1 = st.sample_count + 1
    do_nf = (sample_count1 % 16) == 0
    nf1 = torch.where(do_nf, st.noise_floor * NF_DECAY + torch.minimum(st.pre_capped, st.noise_floor) * NF_NEW + NF_BIAS, st.noise_floor)
    cap = 1.5 * torch.where(p.using_manual, p.manual_level, p.normal_ratio * nf1)

    pre_full1 = st.pre_full * MA_DECAY + s * MA_NEW
    pre_capped1 = torch.where(
        (st.pre_capped >= cap) & (s >= cap), cap, torch.minimum(cap, st.pre_capped * MA_DECAY + s * MA_NEW)
    )
    sq_buffer1 = torch.cat([st.sq_buffer[1:], (pre_capped1 * PRE_VS_POST)[None]], dim=0)
    buf_tail = sq_buffer1[0]  # age-101 value

    lvl1 = _levels(p, nf1, roc1)
    has_pre = pre_capped1 >= lvl1
    has_sig = has_pre & (~upf1 | (st.post_capped >= buf_tail))

    nxt2 = torch.where((cur1 == OPEN) & ~has_sig, _set_state_valid(cur1, CLOSING), nxt1)
    nxt2 = torch.where((cur1 == CLOSED) & has_sig, _set_state_valid(cur1, OPENING), nxt2)

    active = (cur1 != CLOSED) & (cur1 != LSA)
    below = s < lvl1
    lsc2 = torch.where(active, torch.where(below, lsc1 + 1, 0), lsc1)
    lsa_fire = active & below & (lsc2 >= LOW_SIGNAL_ABORT)
    nxt3 = torch.where(lsa_fire, _set_state_valid(cur1, LSA), nxt2)

    # ======== filtering path (rtl_airband.cpp:507-529) ========
    should_filter = (has_pre | (cur1 != CLOSED)) & (cur1 != LSA)
    do_filter = should_filter & p.needs_raw_iq

    idx = (st.dm_phi >> 16).long()
    fract = (st.dm_phi & 0xFFFF).to(torch.float32) * (1.0 / 65536.0)
    s1 = p.sin_lut[idx]
    s2 = p.sin_lut[idx + 1]
    c1 = p.cos_lut[idx]
    c2 = p.cos_lut[idx + 1]
    swf = s1 + (s2 - s1) * fract
    cwf = c1 + (c2 - c1) * fract
    # multiply(real, imag, cwf, -swf) (rtl_airband.cpp:141-144,513)
    re_d = in_r * cwf + in_i * swf
    im_d = in_i * cwf - in_r * swf
    dm_phi1 = torch.where(do_filter, (st.dm_phi + p.dm_dphi) & 0xFFFFFF, st.dm_phi)

    # complex Bessel lowpass biquad (filters.cpp:158-180); state advances only
    # when the reference would call apply() with enabled filter
    adv_lp = do_filter & p.lp_enabled
    x2r = re_d / p.lp_gain
    x2i = im_d / p.lp_gain
    lp_xr1 = _stack_shift(st.lp_xr, x2r, adv_lp)
    lp_xi1 = _stack_shift(st.lp_xi, x2i, adv_lp)
    y2r = (lp_xr1[0] + lp_xr1[2]) + 2.0 * lp_xr1[1] + p.lp_y0 * st.lp_yr[1] + p.lp_y1 * st.lp_yr[2]
    y2i = (lp_xi1[0] + lp_xi1[2]) + 2.0 * lp_xi1[1] + p.lp_y0 * st.lp_yi[1] + p.lp_y1 * st.lp_yi[2]
    lp_yr1 = _stack_shift(st.lp_yr, y2r, adv_lp)
    lp_yi1 = _stack_shift(st.lp_yi, y2i, adv_lp)

    filt_r = torch.where(p.lp_enabled, y2r, re_d)
    filt_i = torch.where(p.lp_enabled, y2i, im_d)
    real = torch.where(do_filter, filt_r, in_r)
    imag = torch.where(do_filter, filt_i, in_i)
    # correctly rounded float32 square root, as sqrtf on the card (torch's
    # vectorized CPU sqrt is not): through float64, where it rounds once
    wavein_mod = torch.where(do_filter, torch.sqrt((real * real + imag * imag).double()).float(), s)

    # process_filtered_sample (squelch.cpp:248-276); called only when lowpass enabled
    pf = do_filter & p.lp_enabled
    opening = cur1 == OPENING
    skip = pf & opening & (delay1 < SQ_BUF)
    init_pf = pf & opening & (delay1 == SQ_BUF)
    post_full_b = torch.where(init_pf, buf_tail, st.post_full)
    post_capped_b = torch.where(init_pf, buf_tail, st.post_capped)
    eff = pf & ~skip
    upf2 = upf1 | eff
    post_full1 = torch.where(eff, post_full_b * MA_DECAY + wavein_mod * MA_NEW, post_full_b)
    post_capped1 = torch.where(
        eff,
        torch.where(
            (post_capped_b >= cap) & (wavein_mod >= cap), cap, torch.minimum(cap, post_capped_b * MA_DECAY + wavein_mod * MA_NEW)
        ),
        post_capped_b,
    )
    close_fire = eff & (post_capped1 < buf_tail)
    nxt4 = torch.where(close_fire, _set_state_valid(cur1, CLOSED), nxt3)

    # ======== demod (rtl_airband.cpp:532-618) ========
    first_open = (cur1 != OPEN) & (nxt4 == OPEN)
    last_open = ((cur1 == CLOSING) & (nxt4 == CLOSED)) | ((cur1 != LSA) & (nxt4 == LSA))
    spa = (cur1 == OPEN) | (cur1 == CLOSING)
    is_am = ~p.is_nfm

    # AM squelch-open AGC bootstrap: the reference's sequential fold over the
    # look-back window, oldest first (rtl_airband.cpp:534-540)
    dl = st.wavein_delay  # [A, C], row 0 oldest
    trigger = first_open & is_am
    agc1 = st.agc
    if bool(trigger.any()):
        boot = st.agc
        for v in dl:
            boot = torch.where(v >= lvl1, boot * 0.9 + v * 0.1, boot)
        agc1 = torch.where(trigger, boot, st.agc)

    env = dl[0]  # wavein[j - AGC_EXTRA]

    # AM envelope demod + AGC (rtl_airband.cpp:548-562)
    am_agc_up = spa & is_am & (wavein_mod > lvl1)
    agc_am = torch.where(am_agc_up, agc1 * 0.995 + wavein_mod * 0.005, agc1)
    w_am = (env - agc_am) / (agc_am * 1.5)
    over = torch.abs(w_am) > 0.8
    w_am = torch.where(over, w_am * 0.85, w_am)
    agc_am = torch.where(spa & is_am & over, agc_am * 1.15, agc_am)

    # NFM discriminator + DC block + de-emphasis (rtl_airband.cpp:564-582)
    if fm_quadri:
        disc = (st.pr * imag - real * st.pj) / (real * real + imag * imag + 1.0) * _M1PI
    else:
        cr = real * st.pr + imag * st.pj
        cj = imag * st.pr - real * st.pj
        disc = _fast_atan2(cj, cr) * _M1PI
    agc_nfm = agc1 * 0.995 + disc * 0.005
    w_n = disc - agc_nfm
    w_n = w_n * (1.0 - p.alpha) + st.prev_waveout * p.alpha

    nfm_adv = spa & p.is_nfm
    pr1 = torch.where(nfm_adv, real, st.pr)
    pj1 = torch.where(nfm_adv, imag, st.pj)
    prev1 = torch.where(nfm_adv, w_n, st.prev_waveout)
    agc2 = torch.where(spa, torch.where(is_am, agc_am, agc_nfm), agc1)

    waveout = torch.where(is_am, w_am, w_n)

    # ======== CTCSS (squelch.cpp:278-292, ctcss.cpp) ========
    slow1, fast1 = st.slow, st.fast
    gate = torch.ones_like(spa)
    if with_ctcss:
        adv_ct = spa & (cur1 != CLOSED) & p.ctcss_enabled
        if bool((adv_ct | ctcss_reset).any()):
            slow1 = _ctcss_bank_step(st.slow, p.slow_coeff, p.slow_mask, p.slow_window, p.slow_ntones, waveout, adv_ct, ctcss_reset)
            adv_fast = adv_ct & ~slow1.enough
            fast1 = _ctcss_bank_step(st.fast, p.fast_coeff, p.fast_mask, p.fast_window, p.fast_ntones, waveout, adv_fast, ctcss_reset)
        gate = torch.where(p.ctcss_enabled, torch.where(slow1.enough, slow1.has_tone, fast1.has_tone), True)

    open_now = spa & gate

    # ======== notch + ampfactor + clamp (rtl_airband.cpp:590-618) ========
    adv_notch = open_now & p.notch_enabled
    nx1 = _stack_shift(st.notch_x, waveout, adv_notch)
    ny2 = p.notch_d0 * nx1[2] - p.notch_d1 * nx1[1] + p.notch_d0 * nx1[0] + p.notch_d1 * st.notch_y[2] - p.notch_d2 * st.notch_y[1]
    ny1 = _stack_shift(st.notch_y, ny2, adv_notch)
    w3 = torch.where(p.notch_enabled, ny2, waveout)
    w4 = w3 * p.ampfactor
    w5 = torch.where(torch.isnan(w4), 0.0, torch.clamp(w4, -1.0, 1.0))
    waveout_final = torch.where(open_now, w5, 0.0)

    iq_gate = open_now & p.has_iq_outputs
    iq_out_r = torch.where(iq_gate, real, 0.0)
    iq_out_i = torch.where(iq_gate, imag, 0.0)

    dl1 = torch.cat([dl[1:], wavein_mod[None]], dim=0)

    st1 = st._replace(
        noise_floor=nf1,
        pre_full=pre_full1,
        pre_capped=pre_capped1,
        post_full=post_full1,
        post_capped=post_capped1,
        using_post_filter=upf2,
        cur=cur1,
        nxt=nxt4,
        delay=delay1,
        low_signal_count=lsc2,
        sample_count=sample_count1,
        open_count=open_count1,
        flappy_count=flappy_count1,
        recent_open_count=roc1,
        closed_sample_count=csc1,
        sq_buffer=sq_buffer1,
        lp_xr=lp_xr1,
        lp_xi=lp_xi1,
        lp_yr=lp_yr1,
        lp_yi=lp_yi1,
        notch_x=nx1,
        notch_y=ny1,
        agc=agc2,
        dm_phi=dm_phi1,
        pr=pr1,
        pj=pj1,
        prev_waveout=prev1,
        fast=fast1,
        slow=slow1,
        wavein_delay=dl1,
    )
    return st1, (waveout_final, last_open & is_am, open_now, iq_out_r, iq_out_i)


def apply_fade_and_tail(waveout_tail: torch.Tensor, waveout: torch.Tensor, fade: torch.Tensor):
    """Post-loop waveout assembly: AGC_EXTRA tail carry + AM squelch-close
    fade-out rewrites.

    A fade at loop step n rewrites full-buffer indices n+1..n+99 (the buffer
    being the carried tail followed by this block's waveout) with
    w_full[n] * 0.94^i, i = 1..99 (reference: rtl_airband.cpp:542-546).
    Closes are >= 197 samples apart, so regions never overlap and every index
    takes at most one rewrite: the one of the latest mark before it, found
    with a running max over mark positions.  Each rewritten value is one
    float32 product, the same one the JAX package's depthwise convolution
    forms (its other terms are zeros).

    waveout_tail: [A, C] carried tail; waveout: [W, C]; fade: [W, C] bool.
    Returns (audio [W, C], new_tail [A, C]).  On the card
    ``demod_cuda.fade_and_tail`` runs the fade-tail kernel in its place,
    equal bit for bit; this stays the CPU path and the kernel's oracle.
    """
    W, C = waveout.shape
    A = waveout_tail.shape[0]
    L = A + W
    dev = waveout.device
    w_full = torch.cat([waveout_tail, waveout], dim=0)  # [L, C]
    pos = torch.arange(L, device=dev)[:, None]
    marks = torch.full((L, C), -L, dtype=torch.int64, device=dev)
    marks[:W] = torch.where(fade, pos[:W], -L)
    last = torch.cummax(marks, dim=0).values  # latest mark at or before m
    last = torch.cat([torch.full((1, C), -L, dtype=torch.int64, device=dev), last[:-1]])  # strictly before m
    age = pos - last
    in_region = age < A
    decay = _fade_decay(dev)[torch.clamp(age, max=A - 1)]
    base = torch.gather(w_full, 0, torch.clamp(last, min=0))
    w_full = torch.where(in_region, base * decay, w_full)
    return w_full[:W], w_full[W:]


def demod_block(
    params: ChannelParams,
    state: DemodState,
    mags: torch.Tensor,  # [W, C] new channelizer magnitudes
    iqs: torch.Tensor,  # [W, C, 2] f32 new channelizer bin IQ
    *,
    fm_quadri: bool = False,
    with_ctcss: bool = True,
    trace: bool = False,
):
    """Process one block of W samples for all channels (plain version).

    Returns (new_state, audio [W, C], iq_out [W, C, 2] f32, open_flags [W, C] bool).
    With ``trace=True`` a fifth return holds the per-sample squelch
    internals, each [W, C]: ``cur``, ``nxt``, ``nf`` (noise floor),
    ``pre_capped``, ``agc``, ``delay`` (state after the sample) and
    ``waveout`` (the loop's output before the fade and tail assembly).
    Tracing changes none of the other returns.
    """
    W, C = mags.shape
    A = AGC_EXTRA
    if W < A:
        raise ValueError(f"block of {W} samples is shorter than the {A}-sample look-back")

    # The per-sample loop consumes IQ with an AGC_EXTRA lag (iq_in[j - A],
    # rtl_airband.cpp:497-498): prepend the carried tail.
    iq_stream = torch.cat([state.iq_tail, iqs[: W - A]], dim=0)

    st = state
    outs, traced = [], []
    for n in range(W):
        st, out = _scan_step(params, st, mags[n], iq_stream[n, :, 0], iq_stream[n, :, 1], fm_quadri, with_ctcss)
        outs.append(out)
        if trace:
            traced.append((st.cur, st.nxt, st.noise_floor, st.pre_capped, st.agc, st.delay))
    waveout, fade, open_now, iq_r, iq_i = (torch.stack(o) for o in zip(*outs))

    audio, new_tail = apply_fade_and_tail(state.waveout_tail, waveout, fade)
    iq_out = torch.stack([iq_r, iq_i], dim=-1)
    st = st._replace(iq_tail=iqs[W - A :].clone(), waveout_tail=new_tail)
    if trace:
        tr = dict(zip(("cur", "nxt", "nf", "pre_capped", "agc", "delay"), (torch.stack(o) for o in zip(*traced))))
        return st, audio, iq_out, open_now, dict(tr, waveout=waveout)
    return st, audio, iq_out, open_now
