"""On-device multi-pass signal subtraction for the GFSK engine (PyTorch).

Counterpart of ``cwsl_digi_tpu/modes/subtract.py``; see its docstring for
the estimation schedule.  Per known burst, for every window of the batch at
once: correlate at the search-grid alignment -> df1 from same-tone symbol
pairs -> dt from tone-change pairs -> re-extract at the shifted start -> df2
touch-up -> time-varying complex gain smoothed over ``GAIN_SMOOTH_SYMS``
symbols -> subtract.  Bursts are refit sequentially, later ones over the
residual of the earlier ones.

The reference's data layout is kept where it fixes the numbers: the
residual carries ``margin`` zero hops on each side, bursts are extracted
from hop-aligned spans of ``(n_sym+1)*sps`` samples, and the reference
waveform is synthesized already offset by the intra-hop start.
"""

from __future__ import annotations

import numpy as np
import torch

from cwsl_digi_tpu_torch.constants import WAVE_SR
from cwsl_digi_tpu_torch.modes import _gfsk_kernels
from cwsl_digi_tpu_torch.modes.gfsk import gaussian_frequency_pulse

# moving-average window (symbols) of the time-varying complex gain
GAIN_SMOOTH_SYMS = 7

_SCAN_BASE = 16


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """float32 cumsum along the last axis, summed in the reference's order.

    ``jnp.cumsum`` on the reference's CPU backend is XLA's rewritten
    reduce-window: sequential float32 adds within blocks of 16, the block
    totals scanned the same way, each block's prefix added last.  The
    synthesis phase accumulates to ~2.4e5 rad over a 12.6 s burst, where
    float32 summation order alone moves it by up to ~0.04 rad; summing in
    the same order keeps the port's residual equal to the reference's to
    rounding, on any device (``torch.cumsum`` sums in float64 on the CPU
    and as a parallel scan on CUDA).
    """
    n = x.shape[-1]
    if n <= _SCAN_BASE:
        cols = [x[..., 0]]
        for i in range(1, n):
            cols.append(cols[-1] + x[..., i])
        return torch.stack(cols, dim=-1)
    nb = -(-n // _SCAN_BASE)
    xp = torch.nn.functional.pad(x, (0, nb * _SCAN_BASE - n))
    within = _cumsum(xp.reshape(*x.shape[:-1], nb, _SCAN_BASE))
    pref = _cumsum(within[..., -1])
    excl = torch.nn.functional.pad(pref[..., :-1], (1, 0))
    out = (excl[..., None] + within).reshape(*x.shape[:-1], nb * _SCAN_BASE)
    return out[..., :n]


def subtract_known(spec, audio: torch.Tensor, params: torch.Tensor,
                   gen_parity: torch.Tensor) -> torch.Tensor:
    """Rebuild the residual: audio minus every known burst.

    audio      [B, T] float32, the ORIGINAL capture
    params     [B, M, k+3] int32: [info bits (k) | t0_hop | f0_bin | valid],
               valid bursts first in every window
    gen_parity [k, n-k] float32 systematic generator
    Returns the [B, T] float32 residual.

    A CPU tensor runs :func:`subtract_known_plain`; any other launches the
    ``subtract_known`` kernel (``csrc/gfsk.cu``), which raises if it cannot
    (no fallback) and never syncs with the host.
    """
    if audio.device.type == "cpu":
        return subtract_known_plain(spec, audio, params, gen_parity)
    return _gfsk_kernels.subtract_known(spec, audio.contiguous(),
                                        params.contiguous(),
                                        gen_parity.contiguous())


def subtract_known_plain(spec, audio: torch.Tensor, params: torch.Tensor,
                         gen_parity: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`subtract_known` (on any device):
    the kernel's oracle.  It syncs with the host once a burst."""
    B, T = audio.shape
    dev = audio.device
    k_info = gen_parity.shape[0]
    hop, sps, n_sym = spec.hop, spec.sps, spec.n_sym
    bps = spec.bits_per_sym
    n_data = len(spec.data_syms)
    L = n_sym * sps
    q_sym = n_sym + 1
    S = q_sym * sps
    n_blk_seg = S // hop
    nb = -(-T // hop)
    t_pad_len = nb * hop
    f32 = torch.float32

    pulse = gaussian_frequency_pulse(sps, spec.bt)
    pulse_pad = torch.as_tensor(
        np.concatenate([np.zeros(sps), pulse, np.zeros(sps)]), dtype=f32,
        device=dev)
    gray = torch.as_tensor(spec.gray_map, dtype=f32, device=dev)
    template = np.zeros(n_sym, np.float32)
    for s, tone in spec.sync_cells:
        template[s] = tone
    template = torch.as_tensor(template, device=dev)
    data_idx = torch.as_tensor(spec.data_syms, device=dev)
    weights = torch.as_tensor([1 << (bps - 1 - b) for b in range(bps)],
                              dtype=f32, device=dev)
    u_all = torch.arange(S, device=dev)[None, :]
    r_sps = torch.arange(sps, device=dev)
    sym_ar = torch.arange(n_sym, device=dev)
    hmod = spec.tone_spacing / WAVE_SR
    t_sym = sps / WAVE_SR
    two_pi = 2.0 * np.pi
    b_ar = torch.arange(B, device=dev)

    margin = n_blk_seg
    nb_pad = nb + 2 * margin
    res = torch.nn.functional.pad(audio, (margin * hop,
                                          t_pad_len - T + margin * hop))

    def extract(blk0):
        m = (blk0 + margin).clamp(0, nb_pad - n_blk_seg)
        pos = m[:, None] * hop + u_all
        return torch.gather(res, 1, pos), m

    def synth(t_pad, fine, f_hz):
        """Reference cos/sin on the hop-aligned grid: the burst begins at
        sample ``fine`` of the span; zero outside the burst."""
        dphi = torch.zeros(B, q_sym, sps, dtype=f32, device=dev)
        for d in (-1, 0, 1, 2):
            idx = (3 - d) * sps + r_sps[None, :] - fine[:, None]
            seg_d = pulse_pad[idx.clamp(0, 5 * sps - 1)]
            dphi = dphi + t_pad[:, d + 1 : d + 1 + q_sym, None] \
                * seg_d[:, None, :]
        dphi = dphi.reshape(B, S) * (two_pi * hmod) \
            + (two_pi / WAVE_SR) * f_hz[:, None]
        phase = _cumsum(dphi)
        mask = ((u_all >= fine[:, None])
                & (u_all < fine[:, None] + L)).to(f32)
        return torch.cos(phase) * mask, torch.sin(phase) * mask

    def per_symbol(seg, zr, zi, fine):
        """Per-symbol complex correlations via cumsum + boundary gather."""
        pr = _cumsum(seg * zr)
        pi = _cumsum(-seg * zi)
        bpos = fine[:, None] + sps * torch.arange(n_sym + 1, device=dev)
        idxb = (bpos - 1).clamp(0, S - 1)
        vr = torch.where(bpos > 0, torch.gather(pr, 1, idxb), 0.0)
        vi = torch.where(bpos > 0, torch.gather(pi, 1, idxb), 0.0)
        return vr[:, 1:] - vr[:, :-1], vi[:, 1:] - vi[:, :-1]

    def df_same(cr, ci, same):
        """Frequency error from same-tone pairs (time error cancels)."""
        pr = cr[:, 1:] * cr[:, :-1] + ci[:, 1:] * ci[:, :-1]
        pi = ci[:, 1:] * cr[:, :-1] - cr[:, 1:] * ci[:, :-1]
        srr = (pr * same).sum(-1)
        sri = (pi * same).sum(-1)
        df = torch.atan2(sri, srr) / (two_pi * t_sym)
        keep = (same.sum(-1) > 0) & (df.abs() < spec.bin_hz)
        return torch.where(keep, df, 0.0), (pr, pi)

    def movsum(x):
        w_half = GAIN_SMOOTH_SYMS // 2
        cs = _cumsum(torch.nn.functional.pad(x, (w_half + 1, w_half)))
        return cs[:, GAIN_SMOOTH_SYMS:] - cs[:, :-GAIN_SMOOTH_SYMS]

    n_m = params.shape[1]
    for mi in range(n_m):
        info, t0, f0_bin, ok = (params[:, mi, :k_info], params[:, mi, k_info],
                                params[:, mi, k_info + 1],
                                params[:, mi, k_info + 2])
        # valid bursts come first: stop at the first step with none
        if not bool((ok != 0).any()):
            break
        t0 = t0.to(torch.int64)
        info_f = info.to(f32)
        par = torch.remainder(info_f @ gen_parity, 2.0)
        cw = torch.cat([info_f, par], dim=1)[:, : n_data * bps]
        v = (cw.reshape(B, n_data, bps) @ weights).to(torch.int64)
        tones = template.expand(B, n_sym).clone()
        tones[:, data_idx] = gray[v]
        zcol = torch.zeros(B, 1, dtype=f32, device=dev)
        t_pad = torch.cat([zcol, tones[:, :1], tones, tones[:, -1:], zcol],
                          dim=1)
        dtone = tones[:, 1:] - tones[:, :-1]
        same = (dtone == 0).to(f32)
        sel = ((dtone.abs() >= 1) & (dtone.abs() <= 3)).to(f32)
        f0 = f0_bin.to(f32) * spec.bin_hz

        # 1) correlate at the search-grid alignment (fine = 0)
        start0 = t0 * hop
        seg0, _ = extract(t0)
        fine0 = torch.zeros(B, dtype=torch.int64, device=dev)
        zr, zi = synth(t_pad, fine0, f0)
        cr, ci = per_symbol(seg0, zr, zi, fine0)
        df1, (pr, pi) = df_same(cr, ci, same)

        # 2) time error from tone-change pairs, df1 removed analytically
        ang = two_pi * df1[:, None] * t_sym
        th = torch.atan2(pi, pr) - ang
        th = torch.atan2(torch.sin(th), torch.cos(th))
        w = torch.sqrt(pr * pr + pi * pi) * sel
        den = two_pi * spec.tone_spacing * (w * dtone * dtone).sum(-1)
        dt = (w * th * dtone).sum(-1) / den.clamp(min=1e-20)
        shift = torch.round(dt * WAVE_SR).to(torch.int64).clamp(
            -(sps - 1), sps - 1)
        start1 = start0 - shift
        blk1 = torch.div(start1, hop, rounding_mode="floor")
        fine1 = start1 - blk1 * hop

        # 3) re-extract at the refined start; df2 touch-up as an analytic
        # linear-phase twist of the synthesis
        seg1, bidx1 = extract(blk1)
        zr, zi = synth(t_pad, fine1, f0 + df1)
        cr, ci = per_symbol(seg1, zr, zi, fine1)
        df2, _ = df_same(cr, ci, same)
        th2 = (two_pi / WAVE_SR) * df2[:, None] * (u_all.to(f32) + 1.0)
        ct, st = torch.cos(th2), torch.sin(th2)
        zr, zi = zr * ct - zi * st, zi * ct + zr * st

        # 4) time-varying complex gain from the per-symbol correlations,
        # each twisted at its symbol centre
        uc = fine1[:, None].to(f32) + (sym_ar[None, :].to(f32) + 0.5) * sps
        thc = (two_pi / WAVE_SR) * df2[:, None] * (uc + 1.0)
        cc, sc = torch.cos(thc), torch.sin(thc)
        ctr = cr * cc + ci * sc
        cti = ci * cc - cr * sc
        s_lo = start1[:, None] + sym_ar[None, :] * sps
        cnt = ((s_lo + sps).clamp(0, T) - s_lo.clamp(0, T)).to(f32)
        den = movsum(cnt).clamp(min=1.0)
        g_re = 2.0 * movsum(ctr) / den
        g_im = 2.0 * movsum(cti) / den
        zrow = torch.zeros(B, 1, dtype=f32, device=dev)
        gr_pad = torch.cat([zrow, g_re, zrow], dim=1)
        gi_pad = torch.cat([zrow, g_im, zrow], dim=1)
        r_ge = r_sps[None, None, :] >= fine1[:, None, None]
        amp_re = torch.where(r_ge, gr_pad[:, 1:, None],
                             gr_pad[:, :-1, None]).reshape(B, S)
        amp_im = torch.where(r_ge, gi_pad[:, 1:, None],
                             gi_pad[:, :-1, None]).reshape(B, S)
        sub = (amp_re * zr - amp_im * zi) * (ok != 0).to(f32)[:, None]
        pos = blk1[:, None] * hop + u_all
        sub = sub * ((pos >= 0) & (pos < T)).to(f32)
        wpos = bidx1[:, None] * hop + u_all
        res = res.index_put((b_ar[:, None], wpos),
                            torch.gather(res, 1, wpos) - sub)
    return res[:, margin * hop : margin * hop + t_pad_len][:, :T]
