"""Batched decoder engine for the q-ary single-tone-per-symbol modes (JT65,
Q65) in PyTorch.

Counterpart of ``cwsl_digi_tpu/modes/qary_engine.py``: a sync tone at known
symbol positions, data symbols carrying one GF(64) value as a tone index.

Device side (:func:`qary_decode_program`): Hann sync and boxcar demod
power spectrograms (one bf16-input DFT matmul over the kept bins, or two
rffts where the DFT matrix would exceed ``DFT_MAT_BYTES_MAX``), sync-tone
correlation over (t0, f0) and its top-K candidates (on a card one launch
of the ``qary_sync`` kernel, ``_qary_kernels``), per-symbol tone-energy
gather -> top-4 values and tones, sums and margins (on a card one launch
of the ``qary_symbols`` kernel), the SNR's noise median (``median_rows``
on a card).  Then either the batched RS
errors-and-erasures Chase on the device (JT65, ``modes/rs_device.py``), or
the GF(64) sum-product decoder under several prior variants (Q65,
``modes/qra.py``), each ending in one small packed copy to the host.
The reference's pure-host RS path (``device_rs=False``, its native trial
loop) is not ported: nothing selects it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cwsl_digi_tpu_torch.constants import WAVE_SR
from cwsl_digi_tpu_torch.convert import tables_to_torch
from cwsl_digi_tpu_torch.device import as_device
from cwsl_digi_tpu_torch.modes import _chase_kernels, _qary_kernels
from cwsl_digi_tpu_torch.modes.base import (DecodeResult, on_device_lock,
                                            window_batch)
from cwsl_digi_tpu_torch.modes.gfsk_engine import (DEVICE_BYTES_BUDGET,
                                                   _bf16_matmul, _median_rows,
                                                   _top_k, device_batch_for)
from cwsl_digi_tpu_torch.modes.rs_device import (chase_tables_device,
                                                 kernel_tables_device,
                                                 rs_chase_program)


@dataclasses.dataclass(frozen=True)
class QarySpec:
    name: str
    n_sym: int
    sps: int
    n_tones: int                 # data alphabet size (64)
    tone_offset: int             # data tone index of value 0 (in tone steps)
    sync_syms: tuple[int, ...]   # symbol indices carrying the sync tone (0)
    data_syms: tuple[int, ...]
    trperiod: float
    signal_start_s: float = 0.5
    fmin_hz: float = 200.0
    fmax_hz: float = 2700.0
    top_k: int = 32
    max_hops: int = 96
    pad_hops: int = 48
    os_t: int = 8                # hops per symbol (time oversampling)
    os_f: int = 4                # nfft / sps (freq oversampling; tone = os_f bins)
    full_e: bool = False         # also return full per-tone energies (for
                                 # the q-ary message-passing decode path)
    snr_offset_db: float = 0.0   # per-mode SNR calibration (tools/snr_check)

    @property
    def hop(self) -> int:
        return self.sps // self.os_t

    @property
    def nfft(self) -> int:
        return self.os_f * self.sps

    @property
    def bin_hz(self) -> float:
        return WAVE_SR / self.nfft

    @property
    def tone_spacing(self) -> float:
        return WAVE_SR / self.sps


def _bin_range(spec: QarySpec) -> tuple[int, int, int]:
    """(fmin_bin, fmax_bin, n_bins): the searched band plus headroom for
    the highest data tone."""
    fmin_bin = int(spec.fmin_hz / spec.bin_hz)
    fmax_bin = int(spec.fmax_hz / spec.bin_hz)
    headroom = spec.os_f * (spec.tone_offset + spec.n_tones)
    return fmin_bin, fmax_bin, fmax_bin - fmin_bin + headroom


def qary_decode_program(spec: QarySpec, audio: torch.Tensor, tabs: dict
                        ) -> dict[str, torch.Tensor]:
    """Demod of a batch of windows ([B, N] float32 audio).

    ``tabs``: window [sps], data_syms, sync_syms and, on the DFT branch,
    dft_mat [sps, 4*n_bins] (boxcar re/im, Hann re/im).  Returns per
    candidate the hard symbols, margins, top-4 tone energies and tones,
    per-symbol total energy, score, t0_hop, f0_bin, snr (and the full
    per-tone energies ``e`` with ``spec.full_e``), as the reference.
    """
    b, n_samples = audio.shape
    sps, hop = spec.sps, spec.hop
    n_hops = (n_samples - sps) // hop + 1
    fmin_bin, fmax_bin, n_bins = _bin_range(spec)
    frames = audio.unfold(1, sps, hop)                         # [B, hops, sps]

    def pad_hops(x):
        return torch.nn.functional.pad(x, (0, 0, spec.pad_hops, spec.pad_hops))

    dft_mat = tabs.get("dft_mat")
    if dft_mat is not None:
        # one DFT matmul over the kept bins, bf16 operands and float32
        # accumulation as the reference's (results depend on the casts)
        four = _bf16_matmul(frames.reshape(b * n_hops, sps), dft_mat)
        four = four.reshape(b, n_hops, 4, n_bins)
        power_sync = pad_hops(four[:, :, 2] ** 2 + four[:, :, 3] ** 2)
        power = pad_hops(four[:, :, 0] ** 2 + four[:, :, 1] ** 2)
        del four
    else:
        def spectrogram(w):
            x = torch.fft.rfft(frames * w, n=spec.nfft, dim=-1)
            return pad_hops(x[:, :, fmin_bin : fmin_bin + n_bins].abs() ** 2)

        power_sync = spectrogram(tabs["window"])
        power = spectrogram(torch.ones_like(tabs["window"]))

    # sync correlation at tone 0 and its top-K
    base = power_sync.mean(dim=(1, 2), keepdim=True) * len(spec.sync_syms)
    top_val, top_idx = _qary_sync(spec, power_sync, base)
    n_f0 = fmax_bin - fmin_bin
    t0 = top_idx // n_f0
    f0 = top_idx % n_f0

    e, top_e, top_tone, e_sum, margin = _symbol_energies(
        spec, power, t0, f0, tabs["data_syms"])

    noise = _median_rows(power_sync)
    sig = top_val * base[:, :, 0] / len(spec.sync_syms)
    snr = 10.0 * torch.log10((sig + 1e-30) / (noise[:, None] + 1e-30)) \
        - 10.0 * np.float32(np.log10(2500.0 / spec.tone_spacing)) \
        + np.float32(spec.snr_offset_db)

    out = {
        "symbols": top_tone[..., 0],   # hard GF(64) values
        "margin": margin,         # [B, K, n_data] log-energy margins
        "top_e": top_e,           # [B, K, n_data, 4] top tone energies
        "top_tone": top_tone,
        "e_sum": e_sum,           # [B, K, n_data] per-symbol total energy
        "score": top_val,
        "t0_hop": t0 - spec.pad_hops,
        "f0_bin": f0 + fmin_bin,
        "snr": snr,
    }
    if e is not None:
        out["e"] = e              # [B, K, n_data, n_tones]
    return out


def _qary_sync_plain(spec: QarySpec, power_sync: torch.Tensor,
                     base: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_qary_sync` in plain PyTorch: the sum of the sync rows'
    shifted slices in ``spec.sync_syms`` order, over base + 1e-30, and a
    stable descending sort of every score a window."""
    b = power_sync.shape[0]
    fmin_bin, fmax_bin, _ = _bin_range(spec)
    n_t0, n_f0 = spec.max_hops, fmax_bin - fmin_bin
    acc = None
    for s in spec.sync_syms:
        h0 = spec.os_t * s
        sl = power_sync[:, h0 : h0 + n_t0, :n_f0]
        acc = sl if acc is None else acc + sl
    score = acc / (base + 1e-30)
    return _top_k(score.reshape(b, -1), spec.top_k)


@functools.lru_cache(maxsize=None)
def _sync_hops(sync_syms: tuple, os_t: int, device: torch.device
               ) -> torch.Tensor:
    """The sync symbols' first rows (os_t x symbol), int32 on ``device``,
    copied there once a mode and device."""
    return torch.tensor([os_t * s for s in sync_syms], dtype=torch.int32,
                        device=device)


def _qary_sync(spec: QarySpec, power_sync: torch.Tensor, base: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sync correlation at tone 0 over (t0 < ``spec.max_hops``, f0 <
    n_f0), normalised by ``base`` [B, 1, 1], and its top ``spec.top_k``
    (values [B, K], flat t0-major indices [B, K]; lower index first on
    ties).  On a CUDA tensor one launch of the ``qary_sync`` kernel
    (``_qary_kernels``; it raises where the kernel cannot run; the score
    map is never written), on a CPU tensor :func:`_qary_sync_plain`."""
    if power_sync.device.type == "cpu":
        return _qary_sync_plain(spec, power_sync, base)
    fmin_bin, fmax_bin, _ = _bin_range(spec)
    hops = _sync_hops(tuple(spec.sync_syms), spec.os_t, power_sync.device)
    return _qary_kernels.qary_sync(
        power_sync.contiguous(), base.reshape(-1).contiguous(), hops,
        spec.max_hops, fmax_bin - fmin_bin, spec.top_k)


def check_sync_kernel(spec: QarySpec) -> None:
    """Raise unless the ``qary_sync`` and ``qary_symbols`` kernels take this
    mode's search and demod."""
    _qary_kernels.check_sync(spec.max_hops, len(spec.sync_syms), spec.top_k)
    if list(spec.sync_syms) != sorted(spec.sync_syms):
        raise ValueError("qary_sync takes the sync symbols ascending")
    _qary_kernels.check_symbols(spec.n_tones)


def _halving_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis (a power of two long) in one fixed order:
    the first half plus the second, halved again until one value is left
    (the ``qary_symbols`` kernel's lane pairs and warp folds)."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _symbol_energies_plain(spec: QarySpec, power: torch.Tensor,
                           t0: torch.Tensor, f0: torch.Tensor,
                           data_syms: torch.Tensor):
    """:func:`_symbol_energies` in plain PyTorch: an advanced-index gather
    of e [B, K, n_data, n_tones], a stable sort of every row for its top
    4, the halving sum and the margin."""
    b = power.shape[0]
    dev = power.device
    sym_hops = t0[:, :, None] + spec.os_t * data_syms.to(
        torch.int64)[None, None, :]
    tone_bins = (f0[:, :, None] + spec.os_f * (
        spec.tone_offset + torch.arange(spec.n_tones, device=dev))[None, None])
    bb = torch.arange(b, device=dev)[:, None, None, None]
    e = power[bb, sym_hops[:, :, :, None], tone_bins[:, :, None, :]]
    top_e, top_tone = _top_k(e, 4)                          # [B, K, n_data, 4]
    e_sum = _halving_sum(e)                                 # [B, K, n_data]
    margin = (torch.log(top_e[..., 0] + 1e-30)
              - torch.log(top_e[..., 1] + 1e-30))
    return (e if spec.full_e else None), top_e, top_tone, e_sum, margin


@functools.lru_cache(maxsize=None)
def _sym_rows(data_syms: tuple, os_t: int, device: torch.device
              ) -> torch.Tensor:
    """The data symbols' first rows (os_t x symbol), int32 on ``device``,
    copied there once a mode and device."""
    return torch.tensor([os_t * s for s in data_syms], dtype=torch.int32,
                        device=device)


def _symbol_energies(spec: QarySpec, power: torch.Tensor, t0: torch.Tensor,
                     f0: torch.Tensor, data_syms: torch.Tensor):
    """The data symbols' tone energies of each candidate (t0, f0 [B, K]):
    (e [B, K, n_data, n_tones] gathered from ``power``, or None unless
    ``spec.full_e``; its top-4 tone hypotheses, energies and tones, per
    symbol, descending and the lower tone first on ties, the compact soft
    information of the list decoders; e_sum [B, K, n_data], the energies'
    sum in :func:`_halving_sum`'s order; margin, log(top_e0 + 1e-30) -
    log(top_e1 + 1e-30)).  ``data_syms`` is ``spec.data_syms`` on the
    device.  On a CUDA tensor one launch of the ``qary_symbols`` kernel
    (``_qary_kernels``, which takes the rows from the spec, copied to the
    card once; it raises where the kernel cannot run), on a CPU tensor
    :func:`_symbol_energies_plain`."""
    if power.device.type == "cpu":
        return _symbol_energies_plain(spec, power, t0, f0, data_syms)
    fmin_bin, fmax_bin, _ = _bin_range(spec)
    rows = _sym_rows(tuple(spec.data_syms), spec.os_t, power.device)
    return _qary_kernels.qary_symbols(
        power.contiguous(), t0.contiguous(), f0.contiguous(), rows,
        spec.os_t * max(spec.data_syms), spec.max_hops, fmax_bin - fmin_bin,
        spec.os_f, spec.os_f * spec.tone_offset, spec.full_e)


def _mp_priors(variants: tuple, e: torch.Tensor) -> torch.Tensor:
    """Per-tone energies [B, K, n, T] -> prior variants [B, K, V, n, T].

    Noncoherent channel likelihoods: noise energy per bin is exponential
    with mean N0; median(e)/ln2 estimates N0 robustly.  gamma<1 flattens
    (robust to N0 overestimate), gamma>1 sharpens; n_erase replaces the
    least-confident symbols' priors with uniform (Chase-style retry).
    """
    bsz, top_k, n_data, n_tones = e.shape
    med = _median_rows(e.reshape(bsz * top_k, -1)).reshape(bsz, top_k, 1, 1)
    n0 = (med / np.float32(np.log(2.0))).clamp(min=1e-30)
    x = e / n0
    x = x - x.amax(dim=-1, keepdim=True)
    x = x.clamp(min=-40.0)
    xs = x.sort(dim=-1).values
    sym_margin = xs[..., -1] - xs[..., -2]             # [B, K, n]
    rank = torch.argsort(torch.argsort(sym_margin, dim=-1, stable=True),
                         dim=-1, stable=True)

    outs = []
    for gamma, n_erase in variants:
        p = torch.softmax(gamma * x, dim=-1)
        if n_erase:
            p = torch.where((rank < n_erase)[..., None],
                            np.float32(1.0 / n_tones), p)
        outs.append(p)
    return torch.stack(outs, dim=2)                    # [B, K, V, n, T]


def _mp_score_pack(accept: float, e, hard, ok, score, t0, f0, snr
                   ) -> torch.Tensor:
    """Re-encode scoring + best-variant selection + output packing.

    s_v = mean_s log(e[s, cw_v[s]] / mean_s e) per variant; among
    converging variants above ``accept`` the best wins.  Returns
    [B, K, n + 5] float32: codeword | ok | score | t0 | f0 | snr.
    """
    bsz, top_k, n_data, n_tones = e.shape
    n_var = hard.shape[2]
    e_cw = torch.gather(e[:, :, None].expand(-1, -1, n_var, -1, -1), -1,
                        hard[..., None])[..., 0]       # [B, K, V, n]
    mean_e = e.mean(dim=-1)[:, :, None, :]
    s = torch.log((e_cw + 1e-30) / (mean_e + 1e-30)).mean(dim=-1)
    s = torch.where(ok & (s >= accept), s, -torch.inf)  # [B, K, V]
    best = s.argmax(dim=-1)                             # [B, K]
    bb = torch.arange(bsz, device=e.device)[:, None]
    kk = torch.arange(top_k, device=e.device)[None, :]
    cw = hard[bb, kk, best]                             # [B, K, n]
    okf = torch.isfinite(s[bb, kk, best])
    return torch.cat([
        cw.to(torch.float32), okf[:, :, None].to(torch.float32),
        score[:, :, None], t0[:, :, None].to(torch.float32),
        f0[:, :, None].to(torch.float32), snr[:, :, None]], dim=-1)


class QaryDecoder:
    """Host wrapper: device symbol demod + the device RS errors-and-erasures
    Chase (``rs``) or the device GF(64) sum-product path (``mp``).

    The decoding tiers and the soft re-encode acceptance are the
    reference's (see its docstring).  :meth:`decode` takes host audio
    (used as float32, without rescaling, as the reference) or a float
    tensor already on ``device``.
    """

    # the Chase program's deterministic erasure tiers (rs_device.DET_TIERS)
    CHASE_DET = 6

    def __init__(self, spec: QarySpec, rs, mode, unpack,
                 min_score: float = 1.5, soft_accept: float = 0.40,
                 mp=None, symbol_perm=None, value_demap=None,
                 device_trials: int = 256,
                 device: torch.device | str | None = None):
        self.spec = spec
        self.rs = rs
        self.mp = mp                  # QaryMPDecoder (q-ary sum-product path)
        self.mode = mode
        self.unpack = unpack          # (info_symbols) -> text or None
        self.device = as_device(device)
        if self.device.type == "cuda":
            # a search the qary_sync kernel does not take is refused now,
            # not in a decode
            check_sync_kernel(spec)
        # channel-domain -> codeword-domain transform (JT65: deinterleave +
        # inverse Gray code).  symbol_perm[s] = transmitted data-symbol
        # position of codeword symbol s; value_demap[tone_value] = GF value.
        self.symbol_perm = (None if symbol_perm is None
                            else np.asarray(symbol_perm, np.int64))
        self.value_demap = (None if value_demap is None
                            else np.asarray(value_demap, np.int64))
        self.min_score = min_score
        self.soft_accept = soft_accept
        self._window = np.hanning(spec.sps).astype(np.float32)
        self._data_syms = np.asarray(spec.data_syms, np.int32)
        self._sync_syms = np.asarray(spec.sync_syms, np.int32)
        # trials per candidate of the batched device RS errors-and-erasures
        # Chase (modes/rs_device.py); mp modes (Q65) take the sum-product path
        self.device_trials = device_trials
        self._host = {"window": self._window, "data_syms": self._data_syms,
                      "sync_syms": self._sync_syms}
        if self._dft_mat is not None:
            self._host["dft_mat"] = self._dft_mat
        if self.symbol_perm is not None:
            self._host["symbol_perm"] = self.symbol_perm
        if self.value_demap is not None:
            self._host["value_demap"] = self.value_demap
        self._tabs = tables_to_torch(self._host, self.device)
        if rs is not None and self.device.type == "cuda":
            # trials the Chase kernels do not take are refused now; their
            # tables and the rs_ee kernel's are copied now, not in a decode
            n = len(spec.data_syms)
            _chase_kernels.check_chase(n, device_trials, self.CHASE_DET)
            kernel_tables_device((n, rs.k, getattr(rs, "fcr", 1)),
                                 self.device)
            chase_tables_device(n, n - rs.k, device_trials - self.CHASE_DET,
                                self.device)

    def tables(self) -> dict[str, torch.Tensor]:
        """Host tables the reference also builds (see ``convert.py``)."""
        return {k: torch.from_numpy(v) for k, v in self._host.items()}

    @on_device_lock
    def decode_arrays_device(self, audio) -> dict[str, torch.Tensor]:
        """Device demod in calls of at most ``_max_device_batch`` windows;
        returns device-resident output tensors.  (The reference pads the
        last call to a whole batch, which keeps one compiled shape and
        changes no window's result; eager calls need no padding.)"""
        audio = window_batch(audio, self.device)
        batch = self._max_device_batch(audio.shape[1])
        chunks = [qary_decode_program(self.spec, audio[i : i + batch],
                                      self._tabs)
                  for i in range(0, audio.shape[0], batch)]
        if len(chunks) == 1:
            return chunks[0]
        return {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}

    @on_device_lock
    def decode_arrays(self, audio) -> dict[str, np.ndarray]:
        return {k: v.cpu().numpy()
                for k, v in self.decode_arrays_device(audio).items()}

    @functools.cached_property
    def max_device_batch(self) -> int:
        """Windows per device call at this mode's T/R (bench/runtime)."""
        n = int(round(self.spec.trperiod * WAVE_SR))
        return self._max_device_batch(n)

    @property
    def spectrogram_branch(self) -> str:
        """"dft" (one bf16-input DFT matmul) or "rfft"."""
        return "rfft" if self._dft_mat is None else "dft"

    # largest DFT-as-matmul matrix worth materializing (f32 bytes)
    DFT_MAT_BYTES_MAX = 256 << 20

    @functools.cached_property
    def _dft_mat(self) -> np.ndarray | None:
        """[sps, 4*n_bins] boxcar+Hann DFT matrix over the kept bins."""
        spec = self.spec
        fmin_bin, _, n_bins = _bin_range(spec)
        if spec.sps * 4 * n_bins * 4 > self.DFT_MAT_BYTES_MAX:
            return None
        kk = fmin_bin + np.arange(n_bins)
        ang = -2.0 * np.pi * np.outer(np.arange(spec.sps), kk) / spec.nfft
        dre, dim = np.cos(ang), np.sin(ang)
        w = self._window.astype(np.float64)[:, None]
        return np.concatenate([dre, dim, w * dre, w * dim],
                              axis=1).astype(np.float32)

    def _max_device_batch(self, n_samples: int) -> int:
        # (the reference also divides by 5 on a TPU without the DFT matrix,
        # for the padded temporaries of its non-power-of-two rfft there: a
        # batch size, not a result; cuFFT needs no such margin)
        n_hops = ((n_samples - self.spec.sps) // self.spec.hop + 1
                  + 2 * self.spec.pad_hops)
        return max(1, device_batch_for(n_hops, self.spec.nfft, 64))

    @on_device_lock
    def decode(self, audio):
        audio = window_batch(audio, self.device)
        if self.mp is not None:
            return self._decode_mp(self.decode_arrays_device(audio))
        return self._decode_device_rs(audio)

    def _results(self, n_windows: int, top_k: int, ok, info, meta
                 ) -> list[list[DecodeResult]]:
        """Per-window DecodeResult lists from the packed device outputs:
        accepted candidates above ``min_score`` that unpack, one per
        message (the highest score), strongest first."""
        spec = self.spec
        results = []
        for wi in range(n_windows):
            seen: dict[bytes, DecodeResult] = {}
            for k in range(top_k):
                if not ok[wi, k] or meta["score"][wi, k] < self.min_score:
                    continue
                text = self.unpack(info[wi, k].astype(np.int64))
                if text is None:
                    continue
                key = bytes(info[wi, k].astype(np.uint8))
                dt = (meta["t0_hop"][wi, k] * spec.hop / WAVE_SR
                      - spec.signal_start_s)
                freq = meta["f0_bin"][wi, k] * spec.bin_hz
                r = DecodeResult(
                    message=text,
                    snr_db=round(float(meta["snr"][wi, k]), 1),
                    dt_s=round(float(dt), 2),
                    freq_hz=round(float(freq), 1),
                    score=float(meta["score"][wi, k]),
                    mode=self.mode,
                    payload_bits=info[wi, k].astype(np.uint8),
                )
                prev = seen.get(key)
                if prev is None or r.score > prev.score:
                    seen[key] = r
            results.append(sorted(seen.values(), key=lambda r: -r.score))
        return results

    def _decode_device_rs(self, audio: torch.Tensor) -> list:
        """Fully device-chained decode: demod -> perm/demap -> batched RS
        chase back to back on the device; one small packed copy (accepted
        info + per-candidate metadata) returns to the host."""
        n_windows = audio.shape[0]
        out = self.decode_arrays_device(audio)
        bsz, top_k = out["score"].shape
        syms, margin = out["symbols"], out["margin"]
        top_e, top_tone, e_sum = out["top_e"], out["top_tone"], out["e_sum"]
        if self.symbol_perm is not None:                # channel -> codeword
            p = self._tabs["symbol_perm"]
            syms, margin = syms[:, :, p], margin[:, :, p]
            top_e, top_tone, e_sum = top_e[:, :, p], top_tone[:, :, p], \
                e_sum[:, :, p]
        if self.value_demap is not None:
            dm = self._tabs["value_demap"]
            syms, top_tone = dm[syms], dm[top_tone]
        c = bsz * top_k
        n = syms.shape[-1]
        # the reference's seed: the int32 sum of every t0_hop of the call,
        # masked to 31 bits (= the int64 sum's low 31 bits)
        seed = out["t0_hop"].sum() & 0x7FFFFFFF
        info, _chase_score, chase_ok = rs_chase_program(
            (n, self.rs.k, getattr(self.rs, "fcr", 1)),
            self.device_trials, self.CHASE_DET, self.soft_accept,
            syms.reshape(c, n), margin.reshape(c, n),
            top_e.reshape(c, n, -1), top_tone.reshape(c, n, -1),
            e_sum.reshape(c, n), seed)
        # one packed copy: info symbols + validity + candidate metadata
        packed = torch.cat([
            info.reshape(bsz, top_k, -1).to(torch.float32),
            chase_ok.reshape(bsz, top_k, 1).to(torch.float32),
            out["score"][:, :, None],
            out["t0_hop"][:, :, None].to(torch.float32),
            out["f0_bin"][:, :, None].to(torch.float32),
            out["snr"][:, :, None],
        ], dim=-1).cpu().numpy()
        kk = self.rs.k
        meta = {"score": packed[:, :, kk + 1],
                "t0_hop": packed[:, :, kk + 2].astype(np.int64),
                "f0_bin": packed[:, :, kk + 3].astype(np.int64),
                "snr": packed[:, :, kk + 4]}
        return self._results(n_windows, top_k, packed[:, :, kk] > 0.5,
                             packed[:, :, :kk].astype(np.int64), meta)

    # prior variants for the MP retry ladder: (temperature, n_erase).
    # γ<1 flattens the likelihoods (robust to N0 overestimate), γ>1
    # sharpens them; n_erase>0 additionally replaces the least-confident
    # symbols' priors with uniform (a Chase-style erasure retry that lets
    # the code's redundancy fill unreliable positions instead of being
    # misled by them).
    MP_VARIANTS = ((1.0, 0), (0.7, 0), (1.35, 0), (1.0, 8), (0.7, 14))

    def _mp_chunks(self, flat: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """The plain message passing of the words ``flat`` [M, n, T] in
        chunks that keep its message arrays inside the device budget (a
        short tail chunk padded with uniform rows, exact no-ops)."""
        n_data, n_tones = flat.shape[1:]
        # per-item working set is ~6 message arrays of [nc, mr, 64] f32
        nc, mr = self.mp.code.h_vars.shape
        per_item = nc * mr * 64 * 4 * 6
        mp_batch = max(1, min(len(flat), DEVICE_BYTES_BUDGET // per_item))
        hards, oks = [], []
        for i in range(0, len(flat), mp_batch):
            chunk = flat[i : i + mp_batch]
            if len(chunk) < mp_batch:
                chunk = torch.cat([
                    chunk,
                    torch.full((mp_batch - len(chunk), n_data, n_tones),
                               1.0 / n_tones, device=flat.device)])
            h, o, _conf = self.mp.decode(chunk)
            hards.append(h)
            oks.append(o)
        return torch.cat(hards)[: len(flat)], torch.cat(oks)[: len(flat)]

    def _decode_mp(self, out: dict) -> list:
        """Q-ary sum-product decode path (Q65): full per-tone energies ->
        symbol likelihoods under ``MP_VARIANTS`` -> batched GF(64) message
        passing (on a card one ``qra_mp`` launch, on the CPU the plain
        version in chunks, ``_mp_chunks``) -> re-encode scoring, all on the
        device; among converging variants the best soft re-encode score
        wins."""
        e = out["e"]                                   # [B, K, n_data, T]
        bsz, top_k, n_data, n_tones = e.shape
        n_var = len(self.MP_VARIANTS)
        flat = _mp_priors(self.MP_VARIANTS, e).reshape(
            bsz * top_k * n_var, n_data, n_tones)
        if flat.device.type == "cuda":
            # the qra_mp kernel keeps each word's messages in shared
            # memory: every word in one launch
            hard, ok, _conf = self.mp.decode(flat)
        else:
            hard, ok = self._mp_chunks(flat)
        hard = hard.reshape(bsz, top_k, n_var, n_data)
        ok = ok.reshape(bsz, top_k, n_var)

        # device scoring + variant selection + one packed copy
        packed = _mp_score_pack(
            self.soft_accept, e, hard, ok, out["score"], out["t0_hop"],
            out["f0_bin"], out["snr"]).cpu().numpy()
        k_info = self.mp.code.k
        meta = {"score": packed[:, :, n_data + 1],
                "t0_hop": packed[:, :, n_data + 2].astype(np.int64),
                "f0_bin": packed[:, :, n_data + 3].astype(np.int64),
                "snr": packed[:, :, n_data + 4]}
        return self._results(bsz, top_k, packed[:, :, n_data] > 0.5,
                             packed[:, :, :k_info].astype(np.int64), meta)
