"""Sections of the port's benchmark (``bench_cuda.py``), one JSON line each.

Counterpart of ``tools/bench_sections.py`` on the port's own modules
(``cwsl_digi_tpu_torch``): the same sections, arguments, seeds and draws.
``bench_cuda.py`` calls them in one process; each can also run alone::

    python tools/torch_bench_sections.py <section> [args...] [--device DEV]
    python tools/torch_bench_sections.py mode_decode FST4-60
    python tools/torch_bench_sections.py decode_production 2 1 --device cpu

Every section takes ``device=`` (default ``cuda:0``, which raises "no
CUDA device" where there is none), synchronizes the card, empties its
cache and resets its memory statistics before it starts, and reports its
own wall (``wall_s``) and peak device memory (``peak_device_bytes``; None
off the card).  Window synthesis stays outside every timed run; each
timed run ends in a synchronize or a host copy of the result.
"""

from __future__ import annotations

import functools
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import torch_parity  # noqa: E402

CHANNELIZER_REPS = 5


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _section(fn):
    """Run ``fn(*args, dev=..., **kw)`` on ``device`` from clean memory
    statistics; add its wall and peak device memory to what it returns."""
    @functools.wraps(fn)
    def run(*args, device=None, **kw) -> dict:
        dev = torch_parity.tool_device(device)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn(*args, dev=dev, **kw)
        _sync(dev)
        out["wall_s"] = time.perf_counter() - t0
        out["peak_device_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                    if dev.type == "cuda" else None)
        return out
    return run


def make_busy_windows(batch: int = 24, per_window: int = 6, seed: int = 5
                      ) -> tuple[np.ndarray, list[list[str]]]:
    """Realistic production mix: ``per_window`` FT8 signals at -20..-5 dB
    per window over noise (``tools/bench_sections.py``'s draws); returns
    the windows and the messages injected into each."""
    from cwsl_digi_tpu_torch.modes import ft8

    rng = np.random.default_rng(seed)
    wlen = int(ft8.T_R * 12_000)
    noise_power = 0.5 / 2500.0 * (12_000 / 2.0)
    wins = np.empty((batch, wlen), np.float32)
    injected = []
    for w in range(batch):
        acc = rng.standard_normal(wlen) * np.sqrt(noise_power)
        slots = np.linspace(600, 2500, per_window) + rng.uniform(
            -40, 40, per_window)
        texts = []
        for f0 in slots:
            text = (f"{torch_parity.random_call(rng)} "
                    f"{torch_parity.random_call(rng)} "
                    f"{torch_parity.random_grid(rng)}")
            snr = float(rng.uniform(-20, -5))
            acc += 10.0 ** (snr / 20.0) * ft8.synthesize(
                text, float(f0), start_s=float(rng.uniform(0.1, 1.0)))
            texts.append(text)
        wins[w] = acc
        injected.append(texts)
    return wins, injected


def upload_int16(audio: np.ndarray, device) -> torch.Tensor:
    """Host audio -> device float32 through the peak-scaled int16 wire
    format ``decode()`` itself uses for host input (the reference's
    Instance::prepareAudio, source/Instance.cpp:294-338); synchronized."""
    dev = torch.device(device)
    peak = np.abs(audio).max(axis=1, keepdims=True)
    scaled = (audio * (32000.0 / np.maximum(peak, 1e-30))).astype(np.int16)
    out = torch.from_numpy(scaled).to(dev).float()
    _sync(dev)
    return out


@_section
def section_channelizer(n_ch: int = 256, fs: int = 192_000, *, dev) -> dict:
    """Seconds per channel-second of ``BatchChannelizer.process`` on one
    second of host IQ (the upload included, as in the reference's bench),
    and beside it the kernel's own device time on device-resident IQ."""
    from chip_smoke import _launch_bound, cuda_ms
    from cwsl_digi_tpu_torch.dsp import _kernels
    from cwsl_digi_tpu_torch.dsp.channelizer import BatchChannelizer

    rng = np.random.default_rng(0)
    bc = BatchChannelizer(fs, np.linspace(-fs / 2 + 8000, fs / 2 - 8000,
                                          n_ch), device=dev)
    n = int(fs * 1.0)
    n -= n % bc._sub
    iq_re = rng.standard_normal(n).astype(np.float32)
    iq_im = rng.standard_normal(n).astype(np.float32)
    launches0 = _kernels.launches["channelize"]
    bc.process((iq_re, iq_im))                          # build + warm
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(CHANNELIZER_REPS):
        bc.process((iq_re, iq_im))
        _sync(dev)
    dt = (time.perf_counter() - t0) / CHANNELIZER_REPS
    launches = _kernels.launches["channelize"] - launches0
    out = {"s_per_channel_second": dt / (n / fs) / n_ch,
           "backend": "cuda" if dev.type == "cuda" else "plain",
           "n_channels": n_ch, "fs": fs, "samples": n,
           "kernel_launches": launches, "device_ms": None,
           "device_s_per_channel_second": None, "device_bound_ms": None}
    if dev.type == "cuda":
        # one launch over the same second, IQ already on the card
        st = bc.state
        x = torch.complex(torch.from_numpy(iq_re), torch.from_numpy(iq_im)
                          ).to(dev)
        iq_ext = torch.cat([st["tail"], x])
        a0 = st["abs_sample"] - st["tail"].shape[0]
        bs = bc.spec.block_size
        rot = bc.tile_rotations(a0, n // bs)
        ms = cuda_ms(lambda: _kernels.channelize(
            iq_ext, bc._taps_packed, bc._coarse, rot, n // bs, bs,
            st["out_phase"], bc.spec.sign), 20)
        out["device_ms"] = ms
        out["device_s_per_channel_second"] = ms / 1e3 / (n / fs) / n_ch
        # least time for the launch's work (chip_smoke's bound)
        out["device_bound_ms"] = max(_launch_bound(bc, iq_ext, rot, n // bs))
    return out


def _judge(decodes: list[list[str]], injected: list[list[str]]
           ) -> tuple[int, list[str]]:
    """(injected messages found in their own window, decoded messages that
    were not injected there)."""
    found = sum(len(set(w) & set(d)) for d, w in zip(decodes, injected))
    false = [m for d, w in zip(decodes, injected) for m in d if m not in w]
    return found, false


@_section
def section_decode_production(batch: int = 0, reps: int = 3, *, dev
                              ) -> dict:
    """Wall per window of ``FT8Decoder.decode`` on a busy band, device-fed.

    The windows are on the card before the clock starts (in production
    the channelizer feeds the decoder on the card; the wideband upload is
    the channelizer term).  Timed: every decode dispatch, the subtraction
    passes, OSD, the host copies of the results and the unpack.  Beside
    it one host-fed run (the int16 upload inside the clock).  Every decode
    list is held against the injected messages; a decoded message that
    was not injected in its window raises (no false decodes)."""
    from cwsl_digi_tpu_torch.modes import ft8
    from cwsl_digi_tpu_torch.modes.base import device_lock

    dec = ft8.FT8Decoder(device=dev)
    batch = batch or dec.max_device_batch
    made = [make_busy_windows(batch, seed=5 + i) for i in range(reps + 1)]
    lock = device_lock(dev)
    wait0 = lock.wait_s

    def messages(res):
        return [sorted(r.message for r in rl) for rl in res]

    decodes = [messages(dec.decode(made[0][0]))]            # warm, counted
    n_decoded = sum(len(d) for d in decodes[0])
    devs = [upload_int16(w, dev) for w, _ in made[1:]]
    ts = []
    for d in devs:
        t0 = time.perf_counter()
        res = dec.decode(d)
        ts.append(time.perf_counter() - t0)
        decodes.append(messages(res))
    del devs
    t0 = time.perf_counter()
    res = dec.decode(made[1][0])
    hostfed = time.perf_counter() - t0
    hostfed_decodes = messages(res)
    injected = [m for _, inj in made for m in inj]
    found, false = _judge([w for b in decodes for w in b], injected)
    _, false_h = _judge(hostfed_decodes, made[1][1])
    false += false_h
    if false:
        raise AssertionError(f"busy-band decode: messages never injected "
                             f"{false}")
    return {"s_per_window": sorted(ts)[len(ts) // 2] / batch,
            "runs_s_per_window": [t / batch for t in ts],
            "s_per_window_hostfed": hostfed / batch,
            "decodes_per_window": n_decoded / batch, "batch": batch,
            "max_device_batch": dec.max_device_batch,
            "found_share": found / sum(len(w) for w in injected),
            "false_messages": false,
            "lock_wait_s": lock.wait_s - wait0,
            "decodes": decodes}


@_section
def section_recall(trials: int = 100, *, dev) -> dict:
    """FT8 recall at -18..-22 dB (``torch_parity.sweep_mode``, the JAX
    section's seed), with its false decodes on noise windows."""
    r = torch_parity.sweep_mode("FT8", trials,
                                snrs=[-18.0, -19.0, -20.0, -21.0, -22.0],
                                verbose=False, device=dev)
    return {"recall": r["recall"], "trials": trials,
            "threshold_db": r["threshold_db"],
            "false_per_noise_window": r["false_per_noise_window"],
            "false_messages": r["false_messages"]}


def _mode_windows(mode: str, batch: int, rng: np.random.Generator
                  ) -> tuple[np.ndarray, list[str]]:
    """``batch`` protocol-exact windows of ``mode`` at -10 dB in noise, and
    the message of each."""
    from cwsl_digi_tpu_torch.modes.gfsk import add_noise_at_snr

    cfg = torch_parity.SWEEPS[mode]
    wins, texts = [], []
    for _ in range(batch):
        clean, text = torch_parity.make_trial(mode, rng, cfg["f0"], cfg["dt"])
        wins.append(add_noise_at_snr(clean, -10.0, 12_000, rng))
        texts.append(text)
    return np.stack(wins), texts


@_section
def section_mode_decode(mode: str, batch: int = 0, reps: int = 2, *, dev
                        ) -> dict:
    """Steady-state ``decode()`` wall per window of ``mode``: the min over
    ``reps`` batches after a warm-up batch.  GFSK decoders are fed on the
    card (as the channelizer feeds them); WSPR's and the q-ary decoders'
    host stages take host arrays, so they are fed from the host.  A batch
    holds at most ``torch_parity.GROUP_SAMPLES`` samples."""
    from cwsl_digi_tpu_torch.constants import get_rx_period
    from cwsl_digi_tpu_torch.modes.base import get_decoder
    from cwsl_digi_tpu_torch.modes.gfsk_engine import GFSKDecoder

    rng = np.random.default_rng(11)
    dec = get_decoder(mode, device=dev)
    batch = batch or min(getattr(dec, "max_device_batch", 8), 24)
    wlen = get_rx_period(mode) * 12_000
    batch = max(1, min(batch, int(torch_parity.GROUP_SAMPLES // wlen)))
    made = [_mode_windows(mode, batch, rng) for _ in range(reps + 1)]
    dec.decode(made[0][0])                               # warm
    device_fed = isinstance(dec, GFSKDecoder)
    ts, found, false = [], 0, []
    for wins, texts in made[1:]:
        d = upload_int16(wins, dev) if device_fed else wins
        _sync(dev)
        t0 = time.perf_counter()
        res = dec.decode(d)
        ts.append(time.perf_counter() - t0)
        del d
        f, x = _judge([[r.message for r in rl] for rl in res],
                      [[t] for t in texts])
        found += f
        false += x
    return {"s_per_window": min(ts) / batch, "batch": batch,
            "runs_s_per_window": [t / batch for t in ts],
            "max_device_batch": dec.max_device_batch,
            "device_fed": device_fed,
            "branch": getattr(dec, "spectrogram_branch", None),
            "found_share": found / (reps * batch), "false_messages": false}


@_section
def section_qary_host_fraction(mode: str, batch: int = 8, *, dev) -> dict:
    """The JAX section's "host fraction" of a q-ary mode: 1 - the wall of
    ``decode_arrays`` (the demod on the device and the copy back) over the
    wall of the whole ``decode``.  In the port the rest of ``decode`` is
    JT65's RS Chase or Q65's message passing, both on the device, and the
    host unpack: the share of the decode after the demod, not of host
    work alone."""
    from cwsl_digi_tpu_torch.modes.base import get_decoder

    rng = np.random.default_rng(13)
    dec = get_decoder(mode, device=dev)
    wins, _ = _mode_windows(mode, batch, rng)
    dec.decode(wins)                                     # warm
    t0 = time.perf_counter()
    dec.decode_arrays(wins)
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec.decode(wins)
    tot = time.perf_counter() - t0
    return {"host_fraction": max(0.0, round(1.0 - dev_s / max(tot, 1e-9), 3)),
            "decode_arrays_s": dev_s, "decode_s": tot, "batch": batch}


SECTIONS = {
    "channelizer": section_channelizer,
    "decode_production": section_decode_production,
    "recall": section_recall,
    "mode_decode": section_mode_decode,
    "qary_host_fraction": section_qary_host_fraction,
}


def main(argv: list[str] | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i : i + 2]
    args = []
    for a in argv[1:]:
        try:
            args.append(int(a))
        except ValueError:
            args.append(a)
    out = SECTIONS[argv[0]](*args, device=device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
