"""Entry points of the port: the FT8 forward step, and a multi-device dry
run of the parallel layer.

Counterpart of ``__graft_entry__.py``:

- :func:`entry` returns the port's batched FT8 ``decode_program`` on the
  card, with example arguments at the reference's shapes;
- :func:`dryrun_multichip` builds meshes of ``n_devices`` entries and runs
  one channel-sharded skim step (channelize + decode of one FT8 burst,
  nothing on the other channels), one time-sharded long FST4W window
  (channelized across the ``t`` axis, then decoded) and, for an even
  ``n_devices >= 4``, the time-sharded channelizer on a 2-D ``ch x t``
  mesh.  It runs on the visible CUDA devices, or on the entries of
  ``devices`` (a virtual mesh when it repeats one device); on several
  cards the skim runs a worker process a card.
"""

from __future__ import annotations

import numpy as np
import torch

from cwsl_digi_tpu_torch.constants import Mode, WAVE_SR, get_rx_period
from cwsl_digi_tpu_torch.device import as_device


def entry(device: torch.device | str | None = None):
    """(fn, example_args): the FT8 decode forward step (``top_k=32``,
    ``bp_iters=10``) on ``device`` (default: the card) and four 15 s
    windows of seeded noise there."""
    from cwsl_digi_tpu_torch.modes import ft8
    from cwsl_digi_tpu_torch.modes.gfsk_engine import decode_program

    dev = as_device(device)
    dec = ft8.FT8Decoder(top_k=32, bp_iters=10, device=dev)
    n_samples = int(ft8.T_R * WAVE_SR)

    def fn(audio):
        return decode_program(dec.spec, audio, dec._tabs, dec.bp)

    rng = np.random.default_rng(0)
    example = torch.from_numpy(
        rng.standard_normal((4, n_samples)).astype(np.float32)).to(dev)
    return fn, (example,)


def long_window_iq(fs: int, n: int, mode: Mode | str, text: str,
                   f0_hz: float, amplitude: float, sigma: float,
                   rng: np.random.Generator) -> np.ndarray:
    """``n`` samples of complex64 white noise (``sigma`` per component)
    with one FST4/FST4W burst of ``mode`` at ``f0_hz`` starting 1 s in,
    added in place in pieces (the burst itself is made at once)."""
    from cwsl_digi_tpu_torch.modes import fst4
    from cwsl_digi_tpu_torch.modes.gfsk import gfsk_modulate_iq

    iq = np.empty(n, np.complex64)
    iq.real = rng.standard_normal(n, dtype=np.float32)
    iq.imag = rng.standard_normal(n, dtype=np.float32)
    iq *= np.float32(sigma)
    sps = fst4.SPS_BY_PERIOD[int(get_rx_period(mode))]
    burst = gfsk_modulate_iq(fst4.encode_message(text, Mode(mode)), f0_hz,
                             sps * fs // WAVE_SR, fs, WAVE_SR / sps)
    burst *= amplitude
    burst = burst[: n - fs]
    step = 1 << 22                  # no complex64 copy of the whole burst
    for i in range(0, len(burst), step):
        part = burst[i : i + step]
        iq[fs + i : fs + i + len(part)] += part
    return iq


# the long window of the dry run, as the reference's
LONG_MODE = "FST4W-900"


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the sharded pipeline on ``n_devices`` mesh entries at 48 kHz
    (see the module docstring); raises if a decode is missing or a quiet
    channel decodes."""
    from cwsl_digi_tpu_torch.dsp.channelizer import BatchChannelizer
    from cwsl_digi_tpu_torch.modes import ft8
    from cwsl_digi_tpu_torch.modes.base import get_decoder
    from cwsl_digi_tpu_torch.modes.gfsk import gfsk_modulate_iq
    from cwsl_digi_tpu_torch.parallel.mesh import make_mesh
    from cwsl_digi_tpu_torch.parallel.pipeline import ShardedSkimStep
    from cwsl_digi_tpu_torch.parallel.timeshard import TimeShardedChannelizer

    # --- channel-sharded skim step: a real FT8 burst rides on one channel
    # of the wideband IQ and must decode there, and only there
    mesh = make_mesh(n_devices, axes=("ch",), devices=devices)
    dev0 = mesh.devices.flat[0]
    fs = 48_000
    n_ch = n_devices * 2
    freqs = np.linspace(-18_000, 18_000, n_ch)
    step = ShardedSkimStep(
        fs, freqs, mesh,
        decoder=ft8.FT8Decoder(top_k=16, bp_iters=20, device=dev0))
    t_window = int(ft8.T_R * fs)
    rng = np.random.default_rng(0)
    iq = 0.02 * (rng.standard_normal(t_window)
                 + 1j * rng.standard_normal(t_window))
    text = "CQ W2AXR FN13"
    target = min(5, n_ch - 1)
    burst = gfsk_modulate_iq(
        ft8.encode_message(text), freqs[target] + 1500.0,
        ft8.SPS * fs // WAVE_SR, fs, ft8.TONE_SPACING)
    start = int(0.5 * fs)
    iq[start : start + len(burst)] += 0.1 * burst
    try:
        results = step.decode_window(iq.astype(np.complex64))
    finally:
        step.close()        # its worker processes, on several cards
    got = {ch: [r.message for r in rl]
           for ch, rl in zip(step.local_channels, results)}
    if text not in got.get(target, []):
        raise AssertionError(f"skim decode failed: {got}")
    quiet = [ch for ch, msgs in got.items() if ch != target and msgs]
    if quiet:
        raise AssertionError(f"false decodes on quiet channels: {got}")

    # --- time-sharded channelizer: a long window channelized across the
    # t axis, then decoded end to end
    long_mode = LONG_MODE
    mesh_t = make_mesh(n_devices, axes=("t",), devices=devices)
    tsc = TimeShardedChannelizer(fs, freqs[:4], mesh_t)
    bs = tsc.spec.block_size
    period = get_rx_period(long_mode)
    t_len = -(-int(period * fs) // (n_devices * bs)) * (n_devices * bs)
    w_text = "K1ABC FN42 30"
    iq2 = long_window_iq(fs, t_len, long_mode, w_text, freqs[1] + 1500.0,
                         0.5, 0.02, rng)
    audio = tsc.channelize(iq2)
    if tuple(audio.shape) != (min(4, n_ch), t_len // bs):
        raise AssertionError(f"time-sharded audio shape {audio.shape}")
    n_win = int(period * WAVE_SR)
    ch_audio = audio[1, :n_win].cpu().numpy()
    res = get_decoder(long_mode, device=dev0).decode(ch_audio[None, :])[0]
    if not any(r.message == w_text for r in res):
        raise AssertionError(f"{long_mode} time-sharded decode failed: "
                             f"{[r.message for r in res]}")

    # --- 2-D mesh (ch x t): the time-sharded channelizer on its t axis,
    # against one device's whole-window channelizer
    shape2d = None
    if n_devices % 2 == 0 and n_devices >= 4:
        mesh2 = make_mesh(n_devices, axes=("ch", "t"),
                          shape=(n_devices // 2, 2), devices=devices)
        tsc2 = TimeShardedChannelizer(fs, freqs[:4], mesh2, axis="t")
        t_len2 = 2 * bs * 256
        iq3 = (rng.standard_normal(t_len2)
               + 1j * rng.standard_normal(t_len2)).astype(np.complex64)
        audio2 = tsc2.channelize(iq3)
        whole = BatchChannelizer(fs, freqs[:4], device=dev0).process_window(
            iq3)
        err = float((audio2.to(dev0) - whole).abs().max())
        if tuple(audio2.shape) != (min(4, n_ch), t_len2 // bs) \
                or not err <= 1e-4:
            raise AssertionError(f"2-D mesh: shape {tuple(audio2.shape)}, "
                                 f"max abs err {err}")
        shape2d = tuple(audio2.shape)
    print(f"dryrun_multichip({n_devices}): OK — "
          f"skim decoded {got[target]!r} on ch {target}, "
          f"time-sharded {long_mode} decoded {w_text!r}, "
          f"2D mesh {shape2d}")
    return {"skim": got, "long_decodes": [r.message for r in res],
            "shape2d": shape2d}
