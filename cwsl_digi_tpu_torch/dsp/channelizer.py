"""Batched channelizer: NCO mix + polyphase FIR decimation, all channels at once.

Counterpart of ``cwsl_digi_tpu/dsp/channelizer.py``.  With ``BS = Fs/(2B)``,
``FO = latency*2*Fs/B`` and the FIR taps ``filt``::

    buf[c, i]   = iq_ext[i] * exp(j*pd_c*(A0 + i))     (raw tail + chunk, mixed)
    y[c, t]     = sum_k filt[k] * buf[c, t*BS + k]        (k < FO)
    audio[c, t] = Re(y[c, t] * (j*sign)^t)

``iq_ext`` is the last ``FO - BS`` raw IQ samples of the previous call
followed by this call's IQ, and ``A0`` the absolute sample index of its
first element.  The streaming state is therefore the *raw* IQ tail, the
absolute sample count and the output phase — what the fused kernel needs,
since it mixes inside the FIR and never stores the mixed signal.  The NCO
phase of every sample comes from float64 host arithmetic (a per-call
rotation times f64-built tables), so float32 phase error never grows with
stream length.

Folding the mix into the taps makes all channels one complex GEMM, which
is the form the kernel computes::

    G[c, k]     = filt[k] * exp(j*pd_c*k)                     (modulated taps)
    y[c, t]     = R[c, t] * sum_k G[c, k] * iq_ext[t*BS + k]
    R[c, t]     = exp(j*pd_c*(A0 + t*BS)) = rot[tile, c] * coarse[c, t - t0]

with ``G`` built once from float64 angles (:func:`modulated_taps`) and
``R`` from float64 host rotations per call (:func:`output_rotations`).

On a CUDA tensor :class:`BatchChannelizer` launches the hand-written kernel
(``dsp/_kernels.py``, ``dsp/csrc/channelizer.cu``); on a CPU tensor it runs
:func:`channelize_block_ref`, the plain PyTorch version that follows the
reference's ``_channelize_block`` (mix, polyphase matmul, diagonal sum).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cwsl_digi_tpu_torch.constants import SSB_BW
from cwsl_digi_tpu_torch.device import as_device
from cwsl_digi_tpu_torch.dsp import _kernels
from cwsl_digi_tpu_torch.dsp.lowpass import build_ssb_filter

# Sub-block length of the plain version's tone basis (samples), as in the
# reference; also the chunk granularity the receiver feeds (``_sub``).
_TONE_SUB = 4096


@dataclasses.dataclass(frozen=True)
class ChannelizerSpec:
    """Static configuration for one receiver's channel bank."""

    fs: int                       # input IQ sample rate
    num_channels: int
    bw: int = SSB_BW
    latency_log2: int = 3
    is_usb: bool = True

    def __post_init__(self) -> None:
        if self.bw == 0 or (self.fs // self.bw // 2) * 2 * self.bw != self.fs \
                or self.fs < 4 * self.bw:
            raise ValueError("Fs/B must be an even integer >= 4")

    @property
    def block_size(self) -> int:
        return self.fs // self.bw // 2

    @property
    def filt_order(self) -> int:
        return (1 << self.latency_log2) * 2 * self.fs // self.bw

    @property
    def num_ws(self) -> int:
        return self.filt_order // self.block_size

    @property
    def out_rate(self) -> int:
        return 2 * self.bw

    @property
    def decimation(self) -> int:
        return self.block_size

    @property
    def sign(self) -> float:
        return 1.0 if self.is_usb else -1.0


def _unit_phasor(ang: np.ndarray) -> np.ndarray:
    """exp(j*ang) as complex64, the angle wrapped to [-pi, pi) in float64."""
    ang = np.angle(np.exp(1j * ang))
    return (np.cos(ang) + 1j * np.sin(ang)).astype(np.complex64)


def modulated_taps(filt: np.ndarray, pd: np.ndarray) -> torch.Tensor:
    """G[c, k] = filt[k] * exp(j*pd_c*k) for k < FO, complex128 [C, FO],
    the angle wrapped to [-pi, pi) in float64 as :func:`_unit_phasor`."""
    filt = torch.as_tensor(np.asarray(filt, np.float64))
    pd = torch.as_tensor(np.asarray(pd, np.float64))
    ang = pd[:, None] * torch.arange(filt.shape[0], dtype=torch.float64)
    ang = torch.remainder(ang + np.pi, 2 * np.pi) - np.pi
    return torch.polar(filt.expand_as(ang).contiguous(), ang)


def output_rotations(rot: torch.Tensor, coarse: torch.Tensor) -> torch.Tensor:
    """R[c, t] = rot[t // N, c] * coarse[c, t % N]: the per-output
    rotation exp(j*pd_c*(A0 + t*BS)) of the GEMM form, [C, n_tiles*N]
    complex64, as the kernel's epilogue forms it (N = tile outputs)."""
    c, n = coarse.shape
    return (rot.T[:, :, None] * coarse[:, None, :]).reshape(c, -1)


def select_output(y: torch.Tensor, out_phase: int, sign: float) -> torch.Tensor:
    """Re(y * (j*sign)^t) for output t counted from ``out_phase``: cycles
    +Re -> -sign*Im -> -Re -> +sign*Im (source/SSBD.hpp:132-135)."""
    n_out = y.shape[1]
    t_idx = (out_phase + torch.arange(n_out, device=y.device)) % 4
    yr, yi = y.real, y.imag
    return torch.where(t_idx == 0, yr,
                       torch.where(t_idx == 1, -sign * yi,
                                   torch.where(t_idx == 2, -yr, sign * yi)))


def channelize_block_ref(spec: ChannelizerSpec, iq_ext: torch.Tensor,
                         tone_sub: torch.Tensor, rot: torch.Tensor,
                         segs: torch.Tensor, out_phase: int) -> torch.Tensor:
    """Plain PyTorch channelizer of one block (the kernel's reference).

    iq_ext:   [FO-BS+T] complex64, raw IQ tail followed by the block
    tone_sub: [C, SUB] complex64, exp(j*pd*u) for u in [0, SUB)
    rot:      [NSUB, C] complex64, exp(j*pd*(A0 + SUB*b)), NSUB*SUB >= len
    segs:     [BS, NWS] float32, segs[r, s] = filt[s*BS + r]
    Returns [C, T//BS] float32 audio.
    """
    bs, nws = spec.block_size, spec.num_ws
    n_ext = iq_ext.shape[0]
    c, sub = tone_sub.shape
    n_out = (n_ext - (nws - 1) * bs) // bs
    tone = (rot.T[:, :, None] * tone_sub[:, None, :]).reshape(c, -1)[:, :n_ext]
    mixed = iq_ext[None, :] * tone                               # [C, H+T]
    blocks = mixed.reshape(c, n_ext // bs, bs)
    bd = torch.complex(torch.matmul(blocks.real, segs),
                       torch.matmul(blocks.imag, segs))          # [C, NB, NWS]
    y = bd[:, 0:n_out, 0]
    for s in range(1, nws):
        y = y + bd[:, s : s + n_out, s]
    return select_output(y, out_phase, spec.sign)


class BatchChannelizer:
    """All channels of one receiver, channelized in one launch per block.

    Replaces: one reference Instance thread per channel
    (source/Instance.cpp:178-285).  ``device`` holds the tables and the
    state; blocks may be host arrays or tensors on that device.
    """

    def __init__(self, fs: int, freqs_hz, bw: int = SSB_BW,
                 latency_log2: int = 3, is_usb: bool = True,
                 device: torch.device | str | None = None) -> None:
        freqs = np.asarray(freqs_hz, dtype=np.float64)
        self.spec = ChannelizerSpec(fs, len(freqs), bw, latency_log2, is_usb)
        for f in freqs:
            if abs(f) > fs / 2 or abs(f + self.spec.sign * bw) > fs / 2:
                raise ValueError(f"channel at {f} Hz outside band (Fs={fs})")
        self.freqs = freqs
        self.device = as_device(device)
        # NCO phase increment per channel (source/SSBD.hpp:110-114)
        self._pd = -2.0 * np.pi * (freqs + self.spec.sign * bw / 2.0) / fs
        bs = self.spec.block_size
        self._sub = max(bs, (_TONE_SUB // bs) * bs)
        # host float64 tables, cast once; same values as the reference's
        ang = self._pd[:, None] * np.arange(self._sub)[None, :]
        self.tone_re = np.cos(ang).astype(np.float32)
        self.tone_im = np.sin(ang).astype(np.float32)
        filt = build_ssb_filter(fs, bw, latency_log2)
        self.segs = filt.reshape(self.spec.num_ws, bs).T.astype(np.float32)
        dev = self.device
        self._tone_sub = torch.complex(torch.from_numpy(self.tone_re),
                                       torch.from_numpy(self.tone_im)).to(dev)
        self._segs = torch.from_numpy(np.ascontiguousarray(self.segs)).to(dev)
        # GEMM-form tables: the modulated taps (in the kernel's layout where
        # the kernel runs) and exp(j*pd*BS*u) over one kernel tile's outputs
        self.taps = modulated_taps(filt, self._pd)
        self._taps_packed = None if dev.type == "cpu" else \
            _kernels.pack_taps(self.taps).to(dev)
        self._coarse = torch.from_numpy(_unit_phasor(
            self._pd[:, None] * bs * np.arange(_kernels.N_TILE)[None, :])
        ).to(dev)
        self.state = self.init_state()

    def tables(self) -> dict[str, torch.Tensor]:
        """The tables the reference also builds (see ``convert.py``)."""
        return {"tone_re": torch.from_numpy(self.tone_re),
                "tone_im": torch.from_numpy(self.tone_im),
                "segs": torch.from_numpy(np.ascontiguousarray(self.segs))}

    def init_state(self) -> dict:
        h = self.spec.filt_order - self.spec.block_size
        return {"tail": torch.zeros(h, dtype=torch.complex64,
                                    device=self.device),
                "abs_sample": 0, "out_phase": 0}

    def reset(self) -> None:
        """Per-window phase reset (the reference recreates SSBD each
        window, source/Instance.cpp:251)."""
        self.state = self.init_state()

    def _to_tensor(self, iq) -> torch.Tensor:
        if isinstance(iq, torch.Tensor):
            if iq.device != self.device:
                raise ValueError(f"iq on {iq.device}, channelizer on "
                                 f"{self.device}")
            return iq.to(torch.complex64)
        if isinstance(iq, (tuple, list)):
            re, im = (np.asarray(x, np.float32) for x in iq)
            arr = re + 1j * im
        else:
            arr = np.asarray(iq)
            if not np.iscomplexobj(arr):
                if arr.ndim == 2 and arr.shape[-1] == 2:
                    arr = arr[:, 0] + 1j * arr[:, 1]
                else:
                    raise ValueError("iq must be complex, (re, im), or [T, 2]")
        return torch.from_numpy(np.ascontiguousarray(
            arr, dtype=np.complex64)).to(self.device)

    def _rotations(self, first: int, step: int, n: int) -> torch.Tensor:
        """[n, C] exp(j*pd*(first + step*b)) from float64 host arithmetic."""
        off = first + step * np.arange(n, dtype=np.float64)
        return torch.from_numpy(
            _unit_phasor(off[:, None] * self._pd[None, :])).to(self.device)

    def tile_rotations(self, a0: int, n_out: int) -> torch.Tensor:
        """[n_tiles, C] exp(j*pd*(a0 + t0*BS)) at each kernel tile's first
        output t0, for a block whose ``iq_ext`` starts at sample a0."""
        n_tiles = -(-n_out // _kernels.N_TILE)
        return self._rotations(a0, _kernels.N_TILE * self.spec.block_size,
                               n_tiles)

    def process(self, iq) -> torch.Tensor:
        """Stream one IQ block -> ``[channels, T//BS]`` float32 audio.

        ``iq`` may be a complex array, an ``(re, im)`` pair, ``[T, 2]``, or
        a complex tensor on the channelizer's device.  The block length
        must be a multiple of ``self._sub`` (use :meth:`process_window` for
        one-shot windows of any multiple of BlockSize)."""
        x = self._to_tensor(iq)
        return self._step(x, plain=x.device.type == "cpu")

    def process_plain(self, iq) -> torch.Tensor:
        """:meth:`process` through the plain PyTorch version on any device:
        what the kernel is held against on the card."""
        return self._step(self._to_tensor(iq), plain=True)

    def channelize_block(self, iq_ext, a0: int, out_phase: int
                         ) -> torch.Tensor:
        """Channelize one block given its own raw tail: ``iq_ext`` is the
        FO-BS raw IQ samples before the block, then the block (any multiple
        of BlockSize), its first sample at absolute index ``a0``, and
        ``out_phase`` the block's first output index mod 4.  Returns
        ``[channels, block/BS]``; the streaming state is neither read nor
        changed.  A time shard of one long window is such a block."""
        x = self._to_tensor(iq_ext)
        h = self.spec.filt_order - self.spec.block_size
        if x.shape[0] < h or (x.shape[0] - h) % self.spec.block_size:
            raise ValueError(f"iq_ext must be {h} tail samples plus a "
                             f"multiple of {self.spec.block_size}")
        return self._block(x, a0, out_phase, plain=x.device.type == "cpu")

    def _block(self, iq_ext: torch.Tensor, a0: int, out_phase: int,
               plain: bool) -> torch.Tensor:
        if plain:
            n_sub = -(-iq_ext.shape[0] // self._sub)
            return channelize_block_ref(
                self.spec, iq_ext, self._tone_sub,
                self._rotations(a0, self._sub, n_sub), self._segs, out_phase)
        bs = self.spec.block_size
        n_out = (iq_ext.shape[0] - self.spec.filt_order + bs) // bs
        return _kernels.channelize(
            iq_ext, self._taps_packed, self._coarse,
            self.tile_rotations(a0, n_out), n_out, bs, out_phase,
            self.spec.sign)

    def _step(self, x: torch.Tensor, plain: bool) -> torch.Tensor:
        t = x.shape[0]
        if t % self._sub != 0:
            raise ValueError(f"block length must be a multiple of {self._sub}")
        st = self.state
        iq_ext = torch.cat([st["tail"], x])
        a0 = st["abs_sample"] - st["tail"].shape[0]
        audio = self._block(iq_ext, a0, st["out_phase"], plain)
        self.state = {
            "tail": iq_ext[t:].clone(),
            "abs_sample": st["abs_sample"] + t,
            "out_phase": (st["out_phase"] + t // self.spec.block_size) % 4,
        }
        return audio

    def process_window(self, iq) -> torch.Tensor:
        """Channelize a whole capture window from phase-reset state; the
        tail is zero-padded to a sub-block and the output trimmed."""
        self.reset()
        x = self._to_tensor(iq)
        t = x.shape[0]
        if t % self.spec.block_size != 0:
            raise ValueError(
                f"window length must be a multiple of {self.spec.block_size}")
        n_out = t // self.spec.block_size
        pad = (-t) % self._sub
        if pad:
            x = torch.cat([x, x.new_zeros(pad)])
        return self.process(x)[:, :n_out]
