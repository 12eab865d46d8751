"""RBN Aggregator feed: WSJT-X-style UDP datagrams.

Byte-compatible with the reference (source/RBNHandler.hpp):

- decode/status datagrams carry the WSJT-X magic ``0xADBCCBDA`` + schema 2
  header (:267-269);
- message type 1 (status) is sent whenever base frequency or mode changed
  since the last report (:178-220);
- message type 2 (decode): program name, new-decode flag, snr, dt (double),
  delta frequency, mode, message text (:222-245);
- a custom status datagram (header ``01..08``) lists active decoders +
  highest decode frequency, triggered every 60 s by the supervisor
  (:154-170, source/CWSL_DIGI.cpp:1230-1252);
- batching loop every 2 s (:137-147).
"""

from __future__ import annotations

import dataclasses
import socket
import struct
import threading
import time
from typing import Callable, Optional

from cwsl_digi_tpu_torch.report.spot import Spot, reporting_mode_name
from cwsl_digi_tpu_torch.version import PROGRAM_NAME, __version__

REPORT_HEADER = bytes([0xAD, 0xBC, 0xCB, 0xDA, 0x00, 0x00, 0x00, 0x02])
STATUS_HEADER = bytes([0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08])
BATCH_PERIOD_S = 2.0


def _s(text: str) -> bytes:
    b = text.encode("ascii", "replace")
    return struct.pack(">I", len(b)) + b


@dataclasses.dataclass
class DecoderEntry:
    mode: str
    freq: int


def build_wsjtx_status(program: str, base_freq: int, mode: str, dx_call: str,
                       snr: int, rx_df: int, de_call: str, de_grid: str) -> bytes:
    """Type-1 status datagram (source/RBNHandler.hpp:178-220)."""
    p = bytearray(REPORT_HEADER)
    p += struct.pack(">I", 1)
    p += _s(program)
    p += struct.pack(">I", 0) + struct.pack(">I", base_freq)   # u64 dial freq
    p += _s(mode)
    p += _s(dx_call)
    p += _s(str(snr))
    p += _s(mode)               # TX mode
    p += b"\x00\x00\x00"        # tx enable, transmitting, decoding
    p += struct.pack(">I", rx_df) + struct.pack(">I", rx_df)
    p += _s(de_call)
    p += _s(de_grid)
    p += _s("AB12")             # DX grid - ignored by RBNA (reference :212)
    p += b"\x00"                # TX watchdog
    p += _s("")                 # submode
    p += b"\x00\x00"            # fast mode, special op mode
    return bytes(p)


def build_wsjtx_decode(program: str, snr: int, delta_freq: int, mode: str,
                       message: str) -> bytes:
    """Type-2 decode datagram (source/RBNHandler.hpp:222-245)."""
    p = bytearray(REPORT_HEADER)
    p += struct.pack(">I", 2)
    p += _s(program)
    p += b"\x01"                          # new decode
    p += struct.pack(">I", 0)             # time (ignored)
    p += struct.pack(">i", snr)
    p += struct.pack(">d", 0.0)           # delta time (ignored)
    p += struct.pack(">I", delta_freq & 0xFFFFFFFF)
    p += _s(mode)
    p += _s(message)
    p += b"\x00\x00"                      # low confidence, off air
    return bytes(p)


def build_custom_status(highest_decode_freq: int,
                        decoders: list[DecoderEntry]) -> list[bytes]:
    """The 01..08-headed decoder-list datagram(s)
    (source/RBNHandler.hpp:154-170).

    The count field is one byte, so configurations beyond 255 decoders
    (routine at this framework's scale) are split across datagrams.
    """
    out = []
    for i in range(0, max(len(decoders), 1), 255):
        chunk = decoders[i : i + 255]
        p = bytearray(STATUS_HEADER)
        p += struct.pack(">I", highest_decode_freq)
        p += bytes([len(chunk)])
        for d in chunk:
            p += _s(d.mode)
            p += struct.pack(">Q", d.freq)
        out.append(bytes(p))
    return out


class RBNHandler:
    """Queueing sender matching the reference's state machine."""

    def __init__(
        self,
        operator_callsign: str,
        operator_locator: str,
        ip: str = "127.0.0.1",
        port: int = 2215,
        send_fn: Optional[Callable[[bytes], None]] = None,
        start_thread: bool = True,
    ) -> None:
        self.de_call = operator_callsign
        self.de_grid = operator_locator
        self.program = f"{PROGRAM_NAME} {__version__}"
        self.addr = (ip, port)
        self._pending: list[Spot] = []
        self._status_pending: list[tuple[int, list[DecoderEntry]]] = []
        self._last_base_freq: int | None = None
        self._last_mode: str | None = None
        self._lock = threading.Lock()
        self._terminate = False
        if send_fn is not None:
            self._send = send_fn
            self._socket = None
        else:
            self._socket = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._send = lambda d: self._socket.sendto(d, self.addr)
        if start_thread:
            threading.Thread(target=self._loop, name="rbn", daemon=True).start()

    def handle(self, spot: Spot) -> None:
        with self._lock:
            self._pending.append(spot)

    def handle_status(self, highest_decode_freq: int,
                      decoders: list[DecoderEntry]) -> None:
        with self._lock:
            self._status_pending.append((highest_decode_freq, list(decoders)))

    def terminate(self) -> None:
        self._terminate = True

    def make_packets(self) -> list[bytes]:
        with self._lock:
            spots = self._pending
            statuses = self._status_pending
            self._pending, self._status_pending = [], []
        packets = [p for h, d in statuses for p in build_custom_status(h, d)]
        for spot in spots:
            mode = reporting_mode_name(spot.mode)
            # status datagram on band/mode change (reference :176-181)
            if spot.base_freq_hz != self._last_base_freq or mode != self._last_mode:
                packets.append(build_wsjtx_status(
                    self.program, spot.base_freq_hz, mode, spot.callsign,
                    spot.snr_db, spot.freq_hz - spot.base_freq_hz,
                    self.de_call, self.de_grid,
                ))
            packets.append(build_wsjtx_decode(
                self.program, spot.snr_db, spot.freq_hz - spot.base_freq_hz,
                mode, spot.message,
            ))
            self._last_base_freq = spot.base_freq_hz
            self._last_mode = mode
        return packets

    def flush(self) -> int:
        n = 0
        for pkt in self.make_packets():
            self._send(pkt)
            n += 1
        return n

    def _loop(self) -> None:  # pragma: no cover - timing loop
        from cwsl_digi_tpu_torch.utils import qos

        qos.set_current_thread_nice(qos.BEST_EFFORT)   # ≙ RBNHandler.hpp:131
        while not self._terminate:
            time.sleep(BATCH_PERIOD_S)
            self.flush()
