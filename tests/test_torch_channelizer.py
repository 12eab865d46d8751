"""The port's channelizer (plain PyTorch version on CPU tensors) against the
JAX package's XLA channelizer, its Pallas kernel in interpret mode and the
float64 oracle; the GEMM form the CUDA kernel computes, and the kernel's
operand layout, emulated here in NumPy.  The CUDA kernel itself is held
against the plain version on the card in ``test_torch_cuda.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cwsl_digi_tpu.dsp.channelizer import BatchChannelizer as JaxChannelizer
from cwsl_digi_tpu.dsp.pallas_channelizer import TILE_C, PallasChannelizer
from cwsl_digi_tpu.dsp.ssbd import SSBD
from cwsl_digi_tpu_torch.dsp import _kernels
from cwsl_digi_tpu_torch.dsp.channelizer import (BatchChannelizer,
                                                 output_rotations)

torch.set_num_threads(1)


def _iq(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)
            ).astype(np.complex64)


def _freqs(fs: int, n: int, usb: bool = True) -> np.ndarray:
    """n channel offsets whose 6 kHz passbands lie inside the band."""
    lo, hi = -0.45 * fs, 0.45 * fs
    return np.linspace(lo, hi - 6000, n) if usb else \
        np.linspace(lo + 6000, hi, n)


@pytest.mark.parametrize("fs", [48_000, 192_000])
@pytest.mark.parametrize("usb", [True, False])
def test_plain_matches_jax_channelizer(fs, usb):
    """Same IQ, streamed in two blocks: atol 1e-4 (float32 sums of FO
    taps in another order and another NCO factorization; output rms
    ~0.2)."""
    freqs = _freqs(fs, 5, usb)
    jb = JaxChannelizer(fs, freqs, is_usb=usb)
    tb = BatchChannelizer(fs, freqs, is_usb=usb, device="cpu")
    iq = _iq(3 * tb._sub, seed=fs + usb)
    for blk in (iq[: 2 * tb._sub], iq[2 * tb._sub:]):
        a = np.asarray(jb.process(blk))
        b = tb.process(blk).numpy()
        assert b.shape == a.shape and b.dtype == np.float32
        np.testing.assert_allclose(b, a, atol=1e-4)


@pytest.mark.parametrize("fs,usb", [(48_000, True), (192_000, False)])
def test_plain_matches_float64_oracle(fs, usb):
    """Against the float64 SSBD oracle: atol 2e-3, the reference's own
    tolerance for its channelizers (tests/test_pallas_channelizer.py)."""
    freqs = _freqs(fs, 4, usb)
    tb = BatchChannelizer(fs, freqs, is_usb=usb, device="cpu")
    iq = _iq(tb._sub * 2 + 8 * tb.spec.block_size, seed=7)
    audio = tb.process_window(iq).numpy()
    assert audio.shape == (4, len(iq) // tb.spec.block_size)
    for i in (0, 3):
        gold = SSBD(fs, 6000, float(freqs[i]), is_usb=usb).process(
            iq.astype(np.complex128))
        np.testing.assert_allclose(audio[i], gold, atol=2e-3)


def test_plain_matches_pallas_interpret():
    """One 8-channel Pallas tile (interpret mode), 192 kHz: atol 1e-4."""
    fs = 192_000
    freqs = np.linspace(-80_000, 80_000, TILE_C)
    pc = PallasChannelizer(fs, freqs)
    tb = BatchChannelizer(fs, freqs, device="cpu")
    iq = _iq(pc.tile_t * 3, seed=11)
    a = np.asarray(pc.process_window(iq))
    b = tb.process_window(iq).numpy()
    np.testing.assert_allclose(b, a, atol=1e-4)


@pytest.mark.parametrize("fs", [48_000, 192_000])
def test_streaming_matches_whole_window(fs):
    """Chunked streaming equals one whole window: atol 1e-4."""
    tb = BatchChannelizer(fs, _freqs(fs, 3), device="cpu")
    iq = _iq(6 * tb._sub, seed=5)
    whole = tb.process_window(iq).numpy()
    tb.reset()
    parts = np.concatenate([tb.process(iq[i : i + tb._sub]).numpy()
                            for i in range(0, len(iq), tb._sub)], axis=1)
    np.testing.assert_allclose(parts, whole, atol=1e-4)


def test_state_save_restore_and_api():
    tb = BatchChannelizer(48_000, _freqs(48_000, 2), device="cpu")
    iq = _iq(2 * tb._sub, seed=9)
    first = tb.process(iq[: tb._sub])
    saved = tb.state
    second = tb.process(iq[tb._sub:])
    tb.process(np.zeros(tb._sub, np.complex64))      # receiver warm()
    tb.state = saved
    again = tb.process(iq[tb._sub:])
    torch.testing.assert_close(again, second, rtol=0, atol=0)
    assert first.shape == (2, tb._sub // tb.spec.block_size)
    with pytest.raises(ValueError):
        tb.process(iq[:100])
    with pytest.raises(ValueError):
        tb.process_window(iq[:101])
    with pytest.raises(ValueError):
        BatchChannelizer(48_000, [30_000.0], device="cpu")  # outside band
    re_im = tb.process_window((iq.real, iq.imag))
    pairs = tb.process_window(np.stack([iq.real, iq.imag], axis=1))
    torch.testing.assert_close(re_im, pairs, rtol=0, atol=0)


def _select(z: np.ndarray, out_phase: int, sign: float) -> np.ndarray:
    """Re(z * (j*sign)^(out_phase + t)) along the last axis."""
    ph = (out_phase + np.arange(z.shape[-1])) % 4
    return np.where(ph == 0, z.real, np.where(
        ph == 1, -sign * z.imag, np.where(ph == 2, -z.real, sign * z.imag)))


def _gemm_form(tb: BatchChannelizer, blk: np.ndarray) -> np.ndarray:
    """One streamed block as the kernel computes it, in float64 from the
    port's tables: Re(R * (G @ X) * (j*sign)^t), X the Hankel view of the
    raw tail + block."""
    st, bs, fo = tb.state, tb.spec.block_size, tb.spec.filt_order
    iq_ext = np.concatenate([st["tail"].numpy(), blk]).astype(np.complex128)
    a0 = st["abs_sample"] - st["tail"].shape[0]
    n_out = len(blk) // bs
    x = np.lib.stride_tricks.sliding_window_view(iq_ext, fo)[::bs][:n_out]
    y = tb.taps.numpy() @ x.T                                  # [C, n_out]
    r = output_rotations(tb.tile_rotations(a0, n_out), tb._coarse).numpy()
    return _select(r[:, :n_out].astype(np.complex128) * y, st["out_phase"],
                   tb.spec.sign)


@pytest.mark.parametrize("fs", [48_000, 192_000])
@pytest.mark.parametrize("usb", [True, False])
def test_gemm_form_matches_plain_and_references(fs, usb):
    """The kernel's algebra (modulated taps, per-output rotation) over
    three receiver chunks and one ragged window: atol 1e-5 against the
    plain version (float32 sums of FO taps against float64), 1e-4 against
    the JAX package's XLA channelizer and 2e-3 against the float64 SSBD
    oracle, the tolerances their own tests state."""
    freqs = _freqs(fs, 5, usb)
    tb = BatchChannelizer(fs, freqs, is_usb=usb, device="cpu")
    jb = JaxChannelizer(fs, freqs, is_usb=usb)
    chunk = 12 * tb._sub                   # the receiver's 0.25 s chunk
    iq = _iq(3 * chunk, seed=fs + 2 * usb)
    for i in range(3):
        blk = iq[i * chunk : (i + 1) * chunk]
        want = _gemm_form(tb, blk)
        np.testing.assert_allclose(tb.process(blk).numpy(), want, atol=1e-5)
        np.testing.assert_allclose(np.asarray(jb.process(blk)), want,
                                   atol=1e-4)
    bs = tb.spec.block_size
    n = 2 * tb._sub + 7 * bs
    tb.reset()
    want = _gemm_form(tb, np.pad(iq[:n], (0, 3 * tb._sub - n)))[:, : n // bs]
    np.testing.assert_allclose(tb.process_window(iq[:n]).numpy(), want,
                               atol=1e-5)
    for ci in (0, 4):
        gold = SSBD(fs, 6000, float(freqs[ci]), is_usb=usb).process(
            iq[:n].astype(np.complex128))
        np.testing.assert_allclose(want[ci], gold, atol=2e-3)


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bfloat16 (to nearest, ties to even), as float64."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).double().numpy()


def _emulate_kernel(tb: BatchChannelizer, blk: np.ndarray) -> np.ndarray:
    """The CUDA kernel's data flow in NumPy: its packed tap fragments, its
    shared-memory IQ (phase pairs, split into bf16 hi and lo) and fragment
    offsets, the m16n8k16 fragment layouts, the three split-bf16 products,
    the accumulator-to-output pairing and the epilogue, for one streamed
    block.  Products summed in float64 (the kernel's split of K over its
    warps only regroups the sum)."""
    st, bs, fo = tb.state, tb.spec.block_size, tb.spec.filt_order
    n_ch = tb.spec.num_channels
    nt, ct = _kernels.N_TILE, _kernels.C_TILE
    taps = _kernels.pack_taps(tb.taps).double().numpy()  # [., FO/16, 32, 16]
    iq_ext = np.concatenate([st["tail"].numpy(), blk])
    a0 = st["abs_sample"] - st["tail"].shape[0]
    n_out = len(blk) // bs
    rot = tb.tile_rotations(a0, n_out).numpy()
    coarse = tb._coarse.numpy()
    nb = nt + fo // bs - 1
    pitch = nb + (2 - nb) % 8
    lane = np.arange(32)
    g, q = lane >> 2, lane & 3
    out = np.zeros((n_ch, n_out), np.float64)
    for tile in range(-(-n_out // nt)):
        t0 = tile * nt
        span = np.zeros(nb * bs, np.complex64)
        seg = iq_ext[t0 * bs : t0 * bs + nb * bs]
        span[: len(seg)] = seg
        # s[p, b, half, (re hi, re lo, im hi, im lo)]
        x = span.reshape(nb, bs // 2, 2).transpose(1, 0, 2)
        s = np.zeros((bs // 2, pitch, 2, 4))
        for part, v in ((0, x.real), (2, x.imag)):
            hi = _bf16(v)
            s[:, :nb, :, part], s[:, :nb, :, part + 1] = hi, _bf16(v - hi)
        s = s.reshape(-1, 2, 4)
        for cy in range(-(-n_ch // ct)):
            d = np.zeros((2, nt // 8, 16, 8))           # [mt, j, row, col]
            for ks in range(fo // 16):
                ka, kb = ks * 16 + 2 * q, ks * 16 + 2 * q + 8
                off_a = (ka % bs) // 2 * pitch + ka // bs + g
                off_b = (kb % bs) // 2 * pitch + kb // bs + g
                for mt in range(2):
                    f = taps[cy * 2 + mt, ks].reshape(32, 2, 4, 2)
                    for a_part, b_parts in ((0, (0, 1)), (1, (0,))):
                        a = f[:, a_part]                 # [lane, reg, pair]
                        ar = np.zeros((16, 16))
                        ai = np.zeros((16, 16))
                        for pr in range(2):
                            for am, regs, signs in (
                                    (ar, (0, 1, 2, 3), (1, 1, 1, 1)),
                                    (ai, (1, 0, 3, 2), (-1, 1, -1, 1))):
                                for (ro, co), reg, sign in zip(
                                        ((0, 0), (8, 0), (0, 8), (8, 8)),
                                        regs, signs):
                                    am[g + ro, 2 * q + co + pr] = \
                                        sign * a[:, reg, pr]
                        for j in range(nt // 8):
                            for am, base in ((ar, 0), (ai, 2)):
                                for b_part in b_parts:
                                    b = np.zeros((16, 8))
                                    ea = s[off_a + 8 * j, :, base + b_part]
                                    eb = s[off_b + 8 * j, :, base + b_part]
                                    for pr in range(2):
                                        b[2 * q + pr, g] = ea[:, pr]
                                        b[2 * q + 8 + pr, g] = eb[:, pr]
                                    d[mt, j] += am @ b
            for mt in range(2):
                for j in range(nt // 8):
                    for ch in range(8):
                        c = cy * ct + mt * 8 + ch
                        for col in range(8):
                            t = t0 + 8 * j + col
                            if c >= n_ch or t >= n_out:
                                continue
                            y = d[mt, j, ch, col] + 1j * d[mt, j, ch + 8, col]
                            r = rot[tile, c] * coarse[c, t - t0]
                            out[c, t] = _select(np.array([r * y]),
                                                st["out_phase"] + t,
                                                tb.spec.sign)[0]
    return out


@pytest.mark.parametrize("fs,usb", [(48_000, True), (48_000, False),
                                    (96_000, True), (192_000, False)])
def test_kernel_layout_emulation_matches_plain(fs, usb):
    """The kernel's operand layout and epilogue, emulated, against the
    GEMM form on 20 channels (a partial 16-channel tile) and 150 outputs (a
    partial 48-output tile) after a first streamed block, at BS 4, 8 and
    16: atol 2e-5 (split-bf16 products keep ~16 bits; outputs of rms ~0.2
    summed over FO taps)."""
    tb = BatchChannelizer(fs, _freqs(fs, 20, usb), is_usb=usb, device="cpu")
    bs = tb.spec.block_size
    iq = _iq(tb._sub + 150 * bs, seed=21 + usb)
    tb.process(iq[: tb._sub])
    got = _emulate_kernel(tb, iq[tb._sub:])
    want = _gemm_form(tb, iq[tb._sub:])
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert np.abs(got).max() > 0.1


def test_packed_taps_split_and_pad():
    """pack_taps: hi and lo are bf16, hi + lo recovers G to ~2^-16
    relative, padded channels are zero, fragment order as stated."""
    tb = BatchChannelizer(96_000, _freqs(96_000, 12), device="cpu")
    g = tb.taps.numpy()
    p = _kernels.pack_taps(tb.taps)
    assert p.dtype == torch.bfloat16
    assert p.shape == (2, tb.spec.filt_order // 16, 32, 16)
    both = (p[..., :8].double() + p[..., 8:].double()).numpy()
    # lane 4*gr+qd of (mt, ks): (Gr, Gi) at taps 16ks+2qd, +1, then at
    # 16ks+2qd+8, +9, each pair lower tap first
    mt, ks, gr, qd = 1, 5, 2, 3
    c, k = 8 * mt + gr, 16 * ks + 2 * qd
    want = [g[c, k].real, g[c, k + 1].real, g[c, k].imag, g[c, k + 1].imag,
            g[c, k + 8].real, g[c, k + 9].real, g[c, k + 8].imag,
            g[c, k + 9].imag]
    np.testing.assert_allclose(both[mt, ks, 4 * gr + qd], want, rtol=0,
                               atol=2e-5 * np.abs(g).max())
    lo = p[..., 8:].double().abs().max()
    assert 0 < lo < 2e-2 * np.abs(g).max()
    assert not p[1, :, 16:].any()                # channels 12..15: padding


@pytest.mark.parametrize("a0,n_out", [(3 * 43_200_000 - 496, 101),
                                      (172_800_000 - 496 - 16 * 50, 50)])
def test_kernel_layout_emulation_at_time_shard_offsets(a0, n_out):
    """A time shard's block as the kernel gets it (the raw halo, a start
    ~1.3e8 samples into a 900 s window at 192 kHz and no multiple of the
    4096-sample sub-block, n_out no multiple of the 48-output tile):
    the emulated kernel against ``channelize_block``'s plain version,
    atol 2e-5 (as above)."""
    tb = BatchChannelizer(192_000, _freqs(192_000, 20), device="cpu")
    bs, h = tb.spec.block_size, tb.spec.filt_order - tb.spec.block_size
    x = _iq(h + n_out * bs, seed=n_out)
    ph = ((a0 + h) // bs) % 4
    want = tb.channelize_block(x, a0, ph).numpy()
    tb.state = {"tail": torch.from_numpy(x[:h]), "abs_sample": a0 + h,
                "out_phase": ph}
    np.testing.assert_allclose(_emulate_kernel(tb, x[h:]), want, atol=2e-5)
    np.testing.assert_allclose(_gemm_form(tb, x[h:]), want, atol=1e-5)
