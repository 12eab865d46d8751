"""Sustained live-load soak of the port: the whole App at N FT8 channels.

Counterpart of ``tools/soak.py`` on the port (``cwsl_digi_tpu_torch``):
synthetic real-time SDR sources -> ingest threads -> the channelizer
kernel -> UTC-framed windows -> DecoderPool -> spot handler, for M windows
at N channels, on the card.  The report records what the scheduler did:

  - stale drops (pool age shedding, reference DecoderPool.hpp:357-377):
    zero at a capacity that holds;
  - ingest overruns (a live block that found the receiver's ~3 s ring
    full);
  - decode busy fraction of the pool's workers;
  - latency per spot: spot time - (window epoch + T/R period), against a
    deadline of one period;
  - the stages: channelize dispatch per audio-second, window-close lag,
    queue wait (for a pool worker), the wait for the device's decode lock
    (``modes/base.py:DeviceLock``) and the decode wall per batch without
    that wait;
  - the injected bursts found, each on its own receiver's dials, and
    ``misrouted``: spots of a burst on another receiver's dials.

``receivers=R`` spreads the channels over R synthetic 192 kHz sources
(``source0=`` ... ``sourceR-1=``, ``rt=1``), each at its own LO with
``channels / R`` dials across its band; each decoder line routes by its
third field, the source number.  R = 1 is the JAX tool's layout (512 dials
344 Hz apart); R = 8 is a site of 8 receivers x 64 dials.

FT8 bursts are scheduled from the App's own anchor: the App's
``setup_receivers`` is wrapped on the instance, and on its first call
every burst is injected at ``anchor + 15 p + dt`` on its receiver's
source, before any source is read (``SyntheticSource`` resolves UTC
bursts once, at its first read).  The run stops once the App has decoded
``channels x windows`` channel-windows, or at a timeout.

Usage (the card by default)::

    python tools/torch_soak.py --channels 512 --receivers 8 --windows 10
    python tools/torch_soak.py --channels 512 --keep-false chiprun_out/ap
    python tools/torch_soak.py --channels 4 --receivers 2 --windows 1 \\
        --device cpu --fs 48000          # rehearsal on the CPU

``--keep-false DIR`` saves, for each channel-window with a decode whose
message was never injected, what the decoder was given: the float32
window as ``.npy`` (the CUDA tensor as it reached the decoder, not the
peak-scaled WAV of the pool's ``keepwav``) and a JSON sidecar with the
mode, dial, window epoch, the false messages, every message of that
channel's decode and the decoder's construction kwargs.

Merge several runs with ``tools/torch_soak_merge.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

FS = 192_000
LO = 14_096_000
EDGE_HZ = 8_000            # dials stay this far inside each source's band
T_R = 15.0                 # FT8 period
SEARCH_HZ = (200.0, 3000.0)  # a dial's FT8 search range (audio Hz)
NOISE = 0.01               # SyntheticSource's noise per component


def build_config(tmp: Path, n_channels: int, fs: int, lo: int,
                 receivers: int = 1, loglevel: int = 2,
                 workers: int | None = None):
    """INI with ``receivers`` synthetic real-time sources, source r at LO
    ``lo + r*fs``, each with ``n_channels / receivers`` FT8 decoder lines
    across its band, routed by source number, and ``workers`` decode slots
    (``[wsjtx] numjt9instances``; the App runs min(slots, 4) pool workers;
    None keeps the reference's sizing rule); returns (config, dials of
    each receiver)."""
    from cwsl_digi_tpu_torch.config import load_config

    if receivers < 1 or n_channels % receivers:
        raise ValueError(f"{n_channels} channels do not split over "
                         f"{receivers} receivers")
    per = n_channels // receivers
    sources, lines, dials = [], [], []
    for r in range(receivers):
        lo_r = lo + r * fs
        f = np.linspace(lo_r - fs // 2 + EDGE_HZ, lo_r + fs // 2 - EDGE_HZ,
                        per).astype(int)
        sources.append(f"source{r}=synthetic:?sr={fs}&lo={lo_r}&rt=1")
        lines += [f"decoder={x} FT8 {r}" for x in f]
        dials.append([int(x) for x in f])
    slots = [] if workers is None else ["[wsjtx]",
                                        f"numjt9instances={workers}"]
    ini = Path(tmp) / "soak.ini"
    ini.write_text("\n".join(
        ["[radio]", *sources, "[operator]", "callsign=W2AXR",
         "gridsquare=FN13", "[decoders]", *lines, *slots, "[logging]",
         f"loglevel={loglevel}", "logimmediately=true"]) + "\n")
    return load_config(ini), dials


@dataclasses.dataclass
class Burst:
    receiver: int
    period: int            # window index from the App's anchor
    dt: float              # start after the window's UTC boundary, s
    rf_hz: float
    snr_db: float
    text: str
    iq: np.ndarray         # complex64 at the source's rate, offset from LO


def plan_bursts(dials: list[list[int]], fs: int, lo: int, n_periods: int,
                per_period: int, seed: int) -> list[Burst]:
    """``per_period`` FT8 bursts in each of ``n_periods`` windows, spread
    over the receivers in turn: each at 800-2200 Hz above a random dial of
    its receiver, SNR -12 to -2 dB in 2.5 kHz, 0.2-1.2 s after the
    boundary, with a message of its own."""
    from torch_parity import random_call, random_grid

    from cwsl_digi_tpu_torch.modes import ft8
    from cwsl_digi_tpu_torch.modes.gfsk import gfsk_modulate_iq

    rng = np.random.default_rng(seed)
    noise_2k5 = 2 * NOISE ** 2 * 2500.0 / fs
    out, texts = [], set()
    for p in range(n_periods):
        for b in range(per_period):
            r = (p * per_period + b) % len(dials)
            lo_r = lo + r * fs
            rf = dials[r][int(rng.integers(len(dials[r])))] + float(
                rng.uniform(800, 2200))
            snr = float(rng.uniform(-12, -2))
            dt = 0.2 + float(rng.uniform(0.0, 1.0))
            text = f"CQ {random_call(rng)} {random_grid(rng)}"
            while text in texts:
                text = f"CQ {random_call(rng)} {random_grid(rng)}"
            texts.add(text)
            amp = np.sqrt(10 ** (snr / 10) * noise_2k5)
            iq = amp * gfsk_modulate_iq(ft8.encode_message(text), rf - lo_r,
                                        ft8.SPS * fs // 12_000, fs,
                                        ft8.TONE_SPACING)
            out.append(Burst(r, p, dt, rf, snr, text, iq.astype(np.complex64)))
    return out


def inject_bursts(src, plan: list[Burst], receiver: int,
                  utc_anchor: float) -> None:
    """Schedule ``receiver``'s bursts on its source at ``utc_anchor + 15 p
    + dt``; before the source's first read, which resolves them."""
    for b in plan:
        if b.receiver == receiver:
            src.inject_at_utc(utc_anchor + T_R * b.period + b.dt, b.iq)


def _pct(xs, q):
    return round(float(np.percentile(np.asarray(xs, np.float64), q)), 3) \
        if len(xs) else None


def judge_spots(spots: list[dict], bursts: list[Burst],
                dials: list[list[int]], decoded: set) -> dict:
    """Hold the spots against the bursts of the windows that were decoded
    (``decoded``: (receiver, window index from the anchor) pairs): a burst
    is found when a spot of its message is on a dial of its own receiver
    whose search range holds it; ``misrouted`` counts spots of a burst on
    another receiver's dials; ``false_spots`` those whose message was never
    injected."""
    rx_of = {d: r for r, ds in enumerate(dials) for d in ds}
    by_text = {b.text: b for b in bursts}
    due = [b for b in bursts if (b.receiver, b.period) in decoded]
    found, misrouted, off_range, false = set(), 0, 0, []
    for s in spots:
        b = by_text.get(s["msg"])
        if b is None:
            false.append(s["msg"])
        elif rx_of.get(s["dial"]) != b.receiver:
            misrouted += 1
        elif SEARCH_HZ[0] <= b.rf_hz - s["dial"] <= SEARCH_HZ[1]:
            found.add(b.text)
        else:
            off_range += 1
    missing = [{"receiver": b.receiver, "period": b.period, "dt": b.dt,
                "rf_hz": b.rf_hz, "snr_db": b.snr_db, "text": b.text}
               for b in due if b.text not in found]
    return {"bursts_due": len(due), "bursts_found": len(due) - len(missing),
            "missing": missing, "misrouted": misrouted,
            "off_range_spots": off_range, "false_spots": false}


def keep_false(out_dir: Path, job, ci: int, messages: list[str],
               false: list[str], receiver: int, decoder_kwargs: dict) -> str:
    """Write channel ``ci`` of ``job`` as float32 ``.npy`` and its JSON
    sidecar into ``out_dir``; returns the file stem."""
    out_dir.mkdir(parents=True, exist_ok=True)
    dial = int(job.base_freqs[ci])
    stem = f"{job.mode.value}_{job.epoch_time:.0f}_{dial}"
    audio = job.audio[ci]
    audio = audio.cpu().numpy() if hasattr(audio, "cpu") else audio
    np.save(out_dir / f"{stem}.npy", np.asarray(audio, np.float32))
    (out_dir / f"{stem}.json").write_text(json.dumps({
        "mode": job.mode.value, "dial": dial, "receiver": receiver,
        "epoch": job.epoch_time, "false": false, "messages": messages,
        "batch_channels": int(job.audio.shape[0]), "channel_index": ci,
        "decoder": decoder_kwargs}, indent=1))
    return stem


def run_soak(channels: int, windows: int, bursts: int, receivers: int,
             device=None, fs: int = FS, lo: int = LO, seed: int = 9,
             timeout_s: float | None = None, loglevel: int = 2,
             workers: int | None = None,
             keep_false_dir: str | Path | None = None) -> dict:
    """Run the port's App live at ``channels`` FT8 dials over
    ``receivers`` synthetic sources (``workers`` decode slots, see
    ``build_config``) until ``channels x windows`` channel-windows are
    decoded (or ``timeout_s``, default the windows plus four periods and
    180 s); returns the report.  With ``keep_false_dir``, every channel
    window with a decode never injected is saved there (``keep_false``)."""
    import torch

    from torch_parity import device_line, tool_device

    from cwsl_digi_tpu_torch.dsp import _kernels
    from cwsl_digi_tpu_torch.modes.base import device_lock
    from cwsl_digi_tpu_torch.runtime import app as app_mod

    dev = tool_device(device)
    card = device_line(dev)
    if timeout_s is None:
        timeout_s = (windows + 4) * T_R + 180.0
    with tempfile.TemporaryDirectory(prefix="torch_soak_") as tmp:
        cfg, dials = build_config(Path(tmp), channels, fs, lo, receivers,
                                  loglevel, workers)
    t0 = time.monotonic()
    plan = plan_bursts(dials, fs, lo, windows + 1, bursts, seed)
    synth_s = time.monotonic() - t0
    spec_rx = {cfg.get("radio", f"source{r}"): r for r in range(receivers)}

    app = app_mod.App(cfg, max_runtime_s=timeout_s + 60, device=dev)
    spots, jobs, decoded, anchor = [], [], set(), {}
    batches, kept, results = [], [], {}
    orig_handle, orig_push = app.spots.handle, app.pool.push
    orig_decode, orig_setup = app.pool._decode, app.setup_receivers
    orig_result = app.pool.on_result
    rx_of = {d: r for r, ds in enumerate(dials) for d in ds}
    lock = device_lock(dev)
    injected = {b.text for b in plan}
    decoder_kwargs = {
        "my_call": cfg.get("operator", "callsign"),
        "depth": max(1, min(3, int(cfg.get("wsjtx", "decodedepth")))),
        "fmax_hz": float(cfg.get("wsjtx", "highestdecodefreq"))}

    def capture(res, **kw):
        s = orig_handle(res, **kw)
        if s is not None:
            spots.append({"msg": res.message, "dial": kw["base_freq_hz"],
                          "latency_s": round(
                              time.time() - (kw["epoch_time"] + T_R), 3)})
        return s

    def push(job):
        jobs.append(job.audio.device.type)
        orig_push(job)

    def on_result(job, ci, res):
        results.setdefault((id(job), ci), []).append(res.message)
        orig_result(job, ci, res)

    def decode(job):
        # the pool's decode wall holds the wait for the device lock; the
        # batch's own decode is the wall without it
        waited0, t = lock.thread_wait_s(), time.monotonic()
        orig_decode(job)
        wall = time.monotonic() - t
        waited = lock.thread_wait_s() - waited0
        batches.append({"lock_wait_s": round(waited, 3),
                        "decode_s": round(wall - waited, 3)})
        rx = rx_of[job.base_freqs[0]]
        decoded.add((rx, int(round((job.epoch_time - anchor["utc"]) / T_R))))
        for ci in range(job.audio.shape[0]):
            msgs = results.pop((id(job), ci), [])
            false = [m for m in msgs if m not in injected]
            if false and keep_false_dir is not None:
                kept.append(keep_false(Path(keep_false_dir), job, ci, msgs,
                                       false, rx, decoder_kwargs))

    def setup(utc_anchor):
        if anchor:
            return orig_setup(utc_anchor)
        anchor.update(utc=utc_anchor, wall=time.monotonic())

        def open_with_bursts(spec, *a, **kw):
            src = open_source(spec, *a, **kw)
            inject_bursts(src, plan, spec_rx.get(spec), utc_anchor)
            return src

        # the sources are opened (and read from) inside setup_receivers
        open_source = app_mod.open_source
        app_mod.open_source = open_with_bursts
        try:
            return orig_setup(utc_anchor)
        finally:
            app_mod.open_source = open_source

    app.spots.handle = capture
    app.pool.push = push
    app.pool._decode = decode
    app.pool.on_result = on_result
    app.setup_receivers = setup

    print(f"soak: {channels} channels on {receivers} receiver(s) x "
          f"{windows} windows, {bursts} bursts a window, "
          f"{app.pool.num_workers} pool workers (real time, {dev}; "
          f"{len(plan)} bursts built in {synth_s:.1f} s)", flush=True)
    want = channels * windows
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    _kernels.launches["channelize"] = 0
    lock_wait0 = lock.wait_s
    run_started = time.time()
    t_run = time.monotonic()
    runner = threading.Thread(target=app.run, daemon=True)
    try:
        runner.start()
        deadline = t_run + timeout_s
        while app.pool.count_decoded_windows < want \
                and time.monotonic() < deadline and runner.is_alive():
            time.sleep(0.2)
        wall_s = time.monotonic() - t_run
        launches = _kernels.launches["channelize"]
        # what the App did up to the stop; the shutdown drains the queue
        n_decoded = app.pool.count_decoded_windows
        got, done = list(spots), set(decoded)
        stage_log = list(app.pool.stage_log)
        batch_log = list(batches)
        lock_wait = lock.wait_s - lock_wait0
        rxs = list(app.receivers.values())
        overruns = sum(rx.overruns for rx in rxs)
        ch_wall = sum(rx.stage["channelize_wall_s"] for rx in rxs)
        ch_audio = sum(rx.stage["channelized_audio_s"] for rx in rxs)
        emit_lags = [v for rx in rxs for v in rx.stage["emit_lag"]]
        busy = app.pool.busy_fraction()
        stale = app.pool.count_dropped_stale
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else None)
    finally:
        app._terminate = True
        runner.join(timeout=60)
    if runner.is_alive():
        raise RuntimeError("the App did not shut down")

    lats = np.asarray([s["latency_s"] for s in got], np.float64)
    judged = judge_spots(got, plan, dials, done)
    report = {
        "channels": channels,
        "receivers": receivers,
        "windows": windows,
        "injected_per_window": bursts,
        "decoded_windows": n_decoded,
        "spots": len(got),
        "unique_messages": len({s["msg"] for s in got}),
        "stale_drops": stale,
        "ingest_overruns": int(overruns),
        "busy_fraction": round(busy, 3),
        "pool_workers": app.pool.num_workers,
        "latency_s": {"p50": _pct(lats, 50), "p95": _pct(lats, 95),
                      "max": _pct(lats, 100)},
        "deadline_misses": int((lats > T_R).sum()),
        "deadline_s": T_R,
        **judged,
        "stages": {
            "channelize_dispatch_s_per_audio_s": round(
                ch_wall / max(ch_audio, 1e-9), 4),
            "window_close_lag_s": {"p50": _pct(emit_lags, 50),
                                   "p95": _pct(emit_lags, 95),
                                   "max": _pct(emit_lags, 100),
                                   "series": [round(v, 2) for v in emit_lags]},
            "queue_wait_s": {
                "p50": _pct([j["queue_wait_s"] for j in stage_log], 50),
                "p95": _pct([j["queue_wait_s"] for j in stage_log], 95),
                "max": _pct([j["queue_wait_s"] for j in stage_log], 100)},
            "lock_wait_s": {
                "p50": _pct([j["lock_wait_s"] for j in batch_log], 50),
                "p95": _pct([j["lock_wait_s"] for j in batch_log], 95),
                "max": _pct([j["lock_wait_s"] for j in batch_log], 100),
                "total": round(lock_wait, 3)},
            "decode_s_per_batch": {
                "p50": _pct([j["decode_s"] for j in batch_log], 50),
                "p95": _pct([j["decode_s"] for j in batch_log], 95),
                "series": [j["decode_s"] for j in batch_log]},
        },
        "kept_false": list(kept),
        "audio_devices": sorted(set(jobs)),
        "channelize_launches": launches,
        "peak_device_bytes": peak,
        "utc_anchor": anchor.get("utc"),
        "run_started_utc": round(run_started, 2),
        "warmup_s": round(anchor["wall"] - t_run, 1) if anchor else None,
        "wall_s": round(wall_s, 1),
        "burst_synthesis_s": round(synth_s, 1),
        "device": str(dev),
        "card": card,
    }
    return report


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=512)
    ap.add_argument("--receivers", type=int, default=1)
    ap.add_argument("--windows", type=int, default=10)
    ap.add_argument("--bursts", type=int, default=6,
                    help="injected FT8 signals per 15 s period")
    ap.add_argument("--fs", type=int, default=FS)
    ap.add_argument("--workers", type=int, default=None,
                    help="decode slots ([wsjtx] numjt9instances); the pool "
                         "runs min(slots, 4) workers")
    ap.add_argument("--out", default=None,
                    help="default chiprun_out/torch_soak_<N>x<R>.json")
    ap.add_argument("--loglevel", type=int, default=2)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--keep-false", default=None, metavar="DIR",
                    help="save each channel-window with a decode never "
                         "injected (float32 .npy + JSON sidecar) in DIR")
    args = ap.parse_args(argv)

    report = run_soak(args.channels, args.windows, args.bursts,
                      args.receivers, args.device, fs=args.fs,
                      loglevel=args.loglevel, workers=args.workers,
                      keep_false_dir=args.keep_false)
    out = Path(args.out or REPO / "chiprun_out" / (
        f"torch_soak_{args.channels}x{args.receivers}"
        f"w{report['pool_workers']}.json"))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    brief = {k: v for k, v in report.items() if k != "stages"}
    brief["stages"] = {k: ({kk: vv for kk, vv in v.items() if kk != "series"}
                           if isinstance(v, dict) else v)
                       for k, v in report["stages"].items()}
    print(json.dumps(brief))
    print(f"wrote {out}")
    return report


if __name__ == "__main__":
    main()
