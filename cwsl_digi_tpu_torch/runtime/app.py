"""The port's application: config -> receivers -> pool -> reporters.

Counterpart of ``cwsl_digi_tpu/runtime/app.py``, with the same config
grammar, reporters, scheduler and supervision loop; the receivers
channelize on ``device`` and the decoders are the port's.  Run with::

    python -m cwsl_digi_tpu_torch.runtime.app --configfile config.ini \
        [section.key=value ...]

It runs on ``cuda:0`` and stops with an error where there is no CUDA
device (tests construct ``App(cfg, device="cpu")``, which runs the plain
PyTorch versions).  It takes every mode of the reference.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

import numpy as np
import torch

from cwsl_digi_tpu_torch.config import Config, load_config
from cwsl_digi_tpu_torch.constants import (WAVE_SR, Mode, get_rx_period,
                                           is_mode_fst4)
from cwsl_digi_tpu_torch.device import as_device
from cwsl_digi_tpu_torch.modes.base import DecoderRegistry, warmup_window
from cwsl_digi_tpu_torch.report.pskreporter import PSKReporter
from cwsl_digi_tpu_torch.report.rbn import DecoderEntry, RBNHandler
from cwsl_digi_tpu_torch.report.spot import SpotHandler
from cwsl_digi_tpu_torch.report.wsprnet import WSPRNet
from cwsl_digi_tpu_torch.runtime.decoderpool import DecoderPool
from cwsl_digi_tpu_torch.runtime.receiver import Receiver, Status
from cwsl_digi_tpu_torch.runtime.scheduler import CadenceScheduler
from cwsl_digi_tpu_torch.sdr.source import open_source
from cwsl_digi_tpu_torch.stats import Stats
from cwsl_digi_tpu_torch.utils.logging import LogLevel, ScreenPrinter
from cwsl_digi_tpu_torch.utils.timeutils import next_period_boundary
from cwsl_digi_tpu_torch.version import PROGRAM_NAME, __version__


class App:
    def __init__(self, cfg: Config, max_runtime_s: float | None = None,
                 device: torch.device | str | None = None) -> None:
        self.cfg = cfg
        self.max_runtime_s = max_runtime_s
        self.device = as_device(device)
        self.printer = ScreenPrinter(
            level=LogLevel(int(cfg.get("logging", "loglevel"))),
            logfile=cfg.get("logging", "logfile") or None,
            immediate=bool(cfg.get("logging", "logimmediately")),
        )
        self._terminate = False
        self.receivers: dict[str, Receiver] = {}
        self.stats = Stats(num_decoders=len(cfg.decoders))

        reporters = []
        self.rbn = None
        if cfg.get("reporting", "pskreporter"):
            reporters.append(PSKReporter(
                cfg.get("operator", "callsign"),
                cfg.get("operator", "gridsquare"),
                log=self.printer.debug,
            ))
        if cfg.get("reporting", "rbn"):
            self.rbn = RBNHandler(
                cfg.get("operator", "callsign"),
                cfg.get("operator", "gridsquare"),
                ip=cfg.get("reporting", "aggregatorip"),
                port=int(cfg.get("reporting", "aggregatorport")),
            )
            reporters.append(self.rbn)
        if cfg.get("reporting", "wsprnet"):
            reporters.append(WSPRNet(
                cfg.get("operator", "gridsquare"),
                cfg.get("operator", "callsign"),
                log=self.printer.warn,
            ))

        self.spots = SpotHandler(
            reporters=reporters,
            stats=self.stats,
            ignored_calls=self._load_ignored(),
            decodes_file=cfg.get("logging", "decodesfile") or None,
            bad_msg_log=cfg.get("logging", "badmsglog") or None,
            log=self.printer.info,
        )
        keep_wav_dir = None
        if cfg.get("wsjtx", "keepwav"):
            keep_wav_dir = cfg.get("wsjtx", "temppath") or "keepwav"

        # decodedepth (jt9 -d), wsprcycles (wsprd -C) and highestdecodefreq
        # (jt9 -H) map to the decoders' knobs as in the reference
        # (cwsl_digi_tpu/runtime/app.py decoder_factory); FT8 gets AP
        # hypotheses seeded with the operator callsign
        # (source/DecoderPool.hpp:466-469)
        depth = max(1, min(3, int(cfg.get("wsjtx", "decodedepth"))))
        cycles = int(cfg.get("wsjtx", "wsprcycles"))
        fmax = float(cfg.get("wsjtx", "highestdecodefreq"))
        self.decoders = DecoderRegistry(self.device)

        def decoder_factory(mode):
            if mode == Mode.FT8:
                return self.decoders.get(
                    mode, my_call=cfg.get("operator", "callsign"),
                    depth=depth, fmax_hz=fmax)
            if mode == Mode.FT4:
                return self.decoders.get(mode, depth=depth, fmax_hz=fmax)
            if mode == Mode.WSPR:
                # wsprd takes no -H; its band is the WSPR sub-band
                return self.decoders.get(mode, cycles=cycles)
            if mode in (Mode.JS8, Mode.JT65, Mode.Q65_30) \
                    or is_mode_fst4(mode):
                return self.decoders.get(mode, fmax_hz=fmax)
            # FST4W keeps the fixed 1400-1600 Hz band (jt9 -L/-H override)
            return self.decoders.get(mode)

        self.pool = DecoderPool(
            num_workers=min(cfg.num_decode_slots(), 4),
            max_long_workers=max(1, cfg.max_long_slots()),
            max_data_age_factor=float(cfg.get("wsjtx", "maxdataage")),
            on_result=self._on_result,
            log=self.printer.debug,
            keep_wav_dir=keep_wav_dir,
            decoder_factory=decoder_factory,
            wav_scale_ft=float(cfg.get("wsjtx", "ftaudioscalefactor")),
            wav_scale_wspr=float(cfg.get("wsjtx", "wspraudioscalefactor")),
        )

    def _load_ignored(self) -> list[str]:
        raw = self.cfg.get("reporting", "ignoredcalls")
        if isinstance(raw, str):
            return raw.upper().split()
        return [str(c).upper() for c in raw]

    def _on_result(self, job, ci, res):
        # `printjt9output`: echo decodes in jt9's text format, WSPR in
        # wsprd's (dial frequency and drift), as the reference does
        if self.cfg.get("logging", "printjt9output"):
            from cwsl_digi_tpu_torch.report import jt9format

            if res.mode == Mode.WSPR:
                line = jt9format.format_wsprd(res, job.epoch_time,
                                              job.base_freqs[ci],
                                              drift=int(round(res.drift_hz)))
            else:
                line = jt9format.format_jt9(res, job.epoch_time)
            self.printer.info(line)
        wspr_call = job.wspr_callsigns[ci] if job.wspr_callsigns else ""
        self.spots.handle(
            res,
            base_freq_hz=job.base_freqs[ci],
            decoder_index=job.decoder_indices[ci],
            epoch_time=job.epoch_time,
            wspr_reporter_call=wspr_call,
        )

    # -- construction -------------------------------------------------------

    def _source_spec_for(self, smnum: int) -> str | None:
        key = f"source{smnum}" if smnum >= 0 else "source"
        try:
            return self.cfg.get("radio", key)
        except KeyError:
            return None

    def _group_lines(self, warn: bool = True) -> dict[str, list[int]]:
        """Decoder-line indices grouped by capture-source spec."""
        groups: dict[str, list[int]] = {}
        for i, line in enumerate(self.cfg.decoders):
            spec = self._source_spec_for(line.smnum)
            if spec is None:
                from cwsl_digi_tpu_torch.sdr.shm import find_band

                name = find_band(line.calibrated_freq, line.smnum)
                if name is None:
                    if warn:
                        self.printer.warn(
                            f"no capture source covers {line.freq} Hz — "
                            "skipped (will retry)")
                    continue
                spec = f"shm:{name}"
            groups.setdefault(spec, []).append(i)
        return groups

    def setup_receivers(self, utc_anchor: float) -> None:
        """Group decoder lines by capture source and build Receivers."""
        for spec, idxs in self._group_lines().items():
            if spec in self.receivers:
                continue
            lines = [self.cfg.decoders[i] for i in idxs]
            try:
                src = open_source(spec)
            except Exception as e:
                self.printer.err(f"cannot open source {spec}: {e}")
                continue
            live = spec.startswith(("shm:", "tcp:")) or getattr(
                src, "live", False)
            try:
                rx = Receiver(src, lines, self.pool, utc_anchor=utc_anchor,
                              log=self.printer.print, line_indices=idxs,
                              align_live=live,
                              channelizer=self.cfg.get("tpu", "channelizer"),
                              device=self.device)
            except ValueError as e:
                self.printer.err(f"cannot attach decoders to {spec}: {e}")
                src.close()
                continue
            # build/warm the channelizer before taking the anchor
            t0 = time.monotonic()
            rx.warm()
            dt_warm = time.monotonic() - t0
            if dt_warm > 1.0:
                self.printer.info(f"receiver warmed in {dt_warm:.0f} s")
            if live:
                rx.set_anchor(next_period_boundary(15.0))
            rx.init()
            self.receivers[spec] = rx
            self.printer.info(
                f"receiver up: {spec} ({len(lines)} decoders, "
                f"SR {src.sample_rate}, LO {src.lo_freq}, {self.device})")

    # -- run ----------------------------------------------------------------

    def warmup(self) -> None:
        """Decode one strong window per configured (source, mode) batch
        shape before receivers start, through every pass arity."""
        shapes: set[tuple] = set()
        for _spec, idxs in self._group_lines(warn=False).items():
            counts: dict = {}
            for i in idxs:
                m = self.cfg.decoders[i].mode
                counts[m] = counts.get(m, 0) + 1
            shapes.update(counts.items())
        for mode, n_ch in sorted(shapes, key=lambda kv: (kv[0].value, kv[1])):
            t0 = time.monotonic()
            dec = self.pool._decoder_factory(mode)
            n = int(get_rx_period(mode) * WAVE_SR)
            batch = np.zeros((n_ch, n), np.float32)
            w = warmup_window(mode)
            m = min(len(w), n)
            batch[0, :m] = w[:m]
            dec.decode(batch)
            if hasattr(dec, "warm_passes"):
                # every pass arity of the multi-pass GFSK decoders
                dec.warm_passes(n_ch)
            self.printer.info(f"warmup: {mode.value} x{n_ch} decoded in "
                              f"{time.monotonic() - t0:.1f} s")

    def run(self) -> None:
        self.printer.info(f"{PROGRAM_NAME} {__version__} starting on "
                          f"{self.device}")
        self.warmup()
        self.pool.init()
        self.setup_receivers(utc_anchor=next_period_boundary(15.0))

        if threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGINT,
                          lambda *_: setattr(self, "_terminate", True))
        started = time.monotonic()
        stats_interval = float(self.cfg.get("logging", "statsreportinginterval"))
        sched = CadenceScheduler()
        sched.subscribe(10.0, lambda _b: self.setup_receivers(
            utc_anchor=next_period_boundary(15.0)))
        if self.rbn is not None:
            sched.subscribe(60.0, lambda _b: self._rbn_status())
        if stats_interval:
            sched.subscribe(stats_interval, lambda _b: self._report_stats())
        while not self._terminate:
            time.sleep(1.0)
            if self.max_runtime_s and \
                    time.monotonic() - started > self.max_runtime_s:
                break
            self._reap_dead_receivers()
            sched.run_once()
        self.cleanup()

    def _reap_dead_receivers(self) -> None:
        """Reap STOPPED receivers, and FINISHED ones of live sources (the
        re-attach cadence rebuilds them); a finished replay is terminal."""
        for spec, rx in list(self.receivers.items()):
            status = rx.get_status()
            live = spec.startswith(("shm:", "tcp:"))
            if status == Status.STOPPED or (
                    status == Status.FINISHED and live):
                self.printer.warn(f"receiver {spec} {status.value} — reaping")
                rx.terminate()
                del self.receivers[spec]

    def _rbn_status(self) -> None:
        entries = [DecoderEntry(line.mode.value, line.freq)
                   for line in self.cfg.decoders]
        self.rbn.handle_status(
            int(self.cfg.get("wsjtx", "highestdecodefreq")), entries)

    def _report_stats(self) -> None:
        labels = [f"{l.freq} {l.mode.value}" for l in self.cfg.decoders]
        statuses = ["Unattached"] * len(self.cfg.decoders)
        for rx in self.receivers.values():
            s = rx.get_status()
            label = "Inactive" if s == Status.FINISHED else s.value
            for idx in rx.line_indices:
                statuses[idx] = label
        self.printer.info(
            "\n" + self.stats.table(labels, statuses)
            + f"\nDecode workers busy: {self.pool.busy_fraction():.0%}"
            f"  windows decoded: {self.pool.count_decoded_windows}"
            f"  stale dropped: {self.pool.count_dropped_stale}")

    def cleanup(self) -> None:
        """Receivers -> pool -> reporters -> printer last."""
        for rx in self.receivers.values():
            rx.terminate()
        self.pool.drain(timeout=10.0)
        self.pool.terminate()
        for rep in self.spots.reporters:
            flush = getattr(rep, "flush", None)
            if flush:
                flush()
            rep.terminate()
        self.printer.info("shutdown complete")
        self.printer.terminate()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog=PROGRAM_NAME)
    ap.add_argument("--configfile", default=None)
    ap.add_argument("--max-runtime", type=float, default=None,
                    help="exit after N seconds (testing)")
    ap.add_argument("overrides", nargs="*", help="section.key=value")
    args = ap.parse_args(argv)
    cfg = load_config(args.configfile, args.overrides)
    if not cfg.decoders:
        print("no decoders configured", file=sys.stderr)
        return 2
    app = App(cfg, max_runtime_s=args.max_runtime)
    app.run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
