"""PSK Reporter client: IPFIX-style UDP reports, byte-compatible with the
reference (source/PSKReporter.{hpp,cpp}).

Wire format reproduced from source/PSKReporter.cpp:
- 16-byte header: 0x000A, length, epoch time, sequence, random session ID
  (:148-177);
- template descriptors for receiver record 0x9992 and sender records
  0x64AF (with locator) / 0x62A7 (without) resent for the first 4 packets
  and whenever >=500 s have passed (:342-366, 441-494);
- receiver-information record: callsign, locator, program name (:179-215);
- sender record: callsign, u32 freq, i8 snr, mode string, [locator],
  info-src 0x01, u32 epoch time, zero-padded to 4 bytes (:261-324);
- dedupe: same callsign+band+mode suppressed for 181 s
  (PSKReporter.hpp:144, :374-386); payloads capped at 1342 bytes
  (PSKReporter.hpp:147); sender loop randomized 18-38 s cadence with 180 ms
  between datagrams (:218-258).
"""

from __future__ import annotations

import random
import socket
import struct
import threading
import time
from typing import Callable, Optional

from cwsl_digi_tpu_torch.report.spot import Spot, reporting_mode_name
from cwsl_digi_tpu_torch.version import PROGRAM_NAME, __version__

HOST = "report.pskreporter.info"
PORT = 4739
MAX_UDP_PAYLOAD_SIZE = 1342                 # PSKReporter.hpp:147
MIN_SECONDS_BETWEEN_SAME_CALLSIGN_REPORTS = 181   # PSKReporter.hpp:144
DESCRIPTOR_RESEND_S = 500
INTER_PACKET_DELAY_S = 0.18
SEND_PERIOD_RANGE_S = (18.0, 38.0)

# Template descriptors, byte-for-byte (source/PSKReporter.cpp:456-494).
DESCRIPTOR_RECEIVER = bytes([
    0x00, 0x03, 0x00, 0x24, 0x99, 0x92, 0x00, 0x03, 0x00, 0x00,
    0x80, 0x02, 0xFF, 0xFF, 0x00, 0x00, 0x76, 0x8F,
    0x80, 0x04, 0xFF, 0xFF, 0x00, 0x00, 0x76, 0x8F,
    0x80, 0x08, 0xFF, 0xFF, 0x00, 0x00, 0x76, 0x8F,
    0x00, 0x00,
])
DESCRIPTOR_SENDER_LOCATOR = bytes([
    0x00, 0x02, 0x00, 0x3C, 0x64, 0xAF, 0x00, 0x07,
    0x80, 0x01, 0xFF, 0xFF, 0x00, 0x00, 0x76, 0x8F,
    0x80, 0x05, 0x00, 0x04, 0x00, 0x00, 0x76, 0x8F,
    0x80, 0x06, 0x00, 0x01, 0x00, 0x00, 0x76, 0x8F,
    0x80, 0x0A, 0xFF, 0xFF, 0x00, 0x00, 0x76, 0x8F,
    0x80, 0x03, 0xFF, 0xFF, 0x00, 0x00, 0x76, 0x8F,
    0x80, 0x0B, 0x00, 0x01, 0x00, 0x00, 0x76, 0x8F,
    0x00, 0x96, 0x00, 0x04,
])
DESCRIPTOR_SENDER_NO_LOCATOR = bytes([
    0x00, 0x02, 0x00, 0x2E, 0x62, 0xA7, 0x00, 0x06,
    0x80, 0x01, 0xFF, 0xFF, 0x00, 0x00, 0x76, 0x8F,
    0x80, 0x05, 0x00, 0x04, 0x00, 0x00, 0x76, 0x8F,
    0x80, 0x06, 0x00, 0x01, 0x00, 0x00, 0x76, 0x8F,
    0x80, 0x0A, 0xFF, 0xFF, 0x00, 0x00, 0x76, 0x8F,
    0x80, 0x0B, 0x00, 0x01, 0x00, 0x00, 0x76, 0x8F,
    0x00, 0x96, 0x00, 0x04,
])


def _pstr(s: str) -> bytes:
    """Length-prefixed string field."""
    b = s.encode("ascii", "replace")
    return bytes([len(b)]) + b


def _pad4(b: bytes) -> bytes:
    return b + bytes((-len(b)) % 4)


def build_header(epoch_time: int, seq: int, session_id: int) -> bytes:
    """source/PSKReporter.cpp:148-177 (length filled by finalize)."""
    return struct.pack(">HHIII", 0x000A, 0, epoch_time & 0xFFFFFFFF,
                       seq & 0xFFFFFFFF, session_id & 0xFFFFFFFF)


def build_receiver_info(callsign: str, locator: str,
                        program: str = f"{PROGRAM_NAME} {__version__}") -> bytes:
    """Receiver record 0x9992 (source/PSKReporter.cpp:179-215)."""
    payload = _pad4(_pstr(callsign) + _pstr(locator) + _pstr(program))
    return struct.pack(">HH", 0x9992, len(payload) + 4) + payload


def build_sender_record(spot: Spot) -> bytes:
    """Sender record 0x64AF/0x62A7 (source/PSKReporter.cpp:261-324)."""
    has_loc = bool(spot.locator)
    body = _pstr(spot.callsign)
    body += struct.pack(">I", spot.freq_hz & 0xFFFFFFFF)
    body += struct.pack("b", max(-128, min(127, spot.snr_db)))
    body += _pstr(reporting_mode_name(spot.mode))
    if has_loc:
        body += _pstr(spot.locator)
    body += b"\x01"                       # info source, always 1
    body += struct.pack(">I", int(spot.epoch_time) & 0xFFFFFFFF)
    rec_id = 0x64AF if has_loc else 0x62A7
    rec = _pad4(struct.pack(">HH", rec_id, 0) + body)
    # size field covers the whole record incl. the 4-byte prefix
    # (reference writes only the low byte due to a shift typo at
    # PSKReporter.cpp:320; records are <256 B so the wire bytes match)
    return rec[:2] + struct.pack(">H", len(rec)) + rec[4:]


def finalize_packet(packet: bytearray) -> bytes:
    struct.pack_into(">H", packet, 2, len(packet))
    return bytes(packet)


def is_same_band(f1: int, f2: int) -> bool:
    """source/PSKReporter.cpp:424-432."""
    divisor = 1_000_000
    if f1 <= 1_000_000 or f2 <= 1_000_000:
        divisor = 100_000
    return f1 // divisor == f2 // divisor


class PSKReporter:
    """Batching sender with the reference's cadence and dedupe policy."""

    def __init__(
        self,
        callsign: str,
        locator: str,
        host: str = HOST,
        port: int = PORT,
        send_fn: Optional[Callable[[bytes], None]] = None,
        start_thread: bool = True,
        log: Callable[[str], None] | None = None,
    ) -> None:
        self.callsign = callsign
        self.locator = locator
        self.host, self.port = host, port
        self._seq = 0
        self._session_id = random.getrandbits(32)
        self._pending: list[Spot] = []
        self._sent: list[Spot] = []
        self._packets_with_descriptors = 0
        self._descriptors_sent_at = 0.0
        self._lock = threading.Lock()
        self._terminate = False
        self.log = log or (lambda s: None)
        self.count_sent = 0
        if send_fn is not None:
            self._send = send_fn
            self._socket = None
        else:
            self._socket = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._send = self._send_udp
        self._thread = None
        if start_thread:
            self._thread = threading.Thread(
                target=self._loop, name="pskreporter", daemon=True
            )
            self._thread.start()

    # -- reference API ------------------------------------------------------

    def handle(self, spot: Spot) -> None:
        with self._lock:
            self._pending.append(spot)

    def terminate(self) -> None:
        self._terminate = True

    # -- internals ----------------------------------------------------------

    def _send_udp(self, data: bytes) -> None:
        try:
            self._socket.sendto(data, (self.host, self.port))
        except OSError as e:  # pragma: no cover - network dependent
            self.log(f"PSK Reporter send error: {e}")

    def _deduped_pending(self) -> list[Spot]:
        """Drop spots whose call+band+mode was reported <=181 s ago
        (source/PSKReporter.cpp:374-386)."""
        now = int(time.time())
        self._sent = [
            s for s in self._sent
            if now - s.epoch_time <= 2 * MIN_SECONDS_BETWEEN_SAME_CALLSIGN_REPORTS
        ]
        out = []
        for spot in self._pending:
            dup = any(
                s.callsign == spot.callsign
                and is_same_band(s.freq_hz, spot.freq_hz)
                and s.mode == spot.mode
                and spot.epoch_time - s.epoch_time
                <= MIN_SECONDS_BETWEEN_SAME_CALLSIGN_REPORTS
                for s in self._sent
            )
            if not dup:
                out.append(spot)
                self._sent.append(spot)
        self._pending = []
        return out

    def make_packets(self) -> list[bytes]:
        """Drain pending spots into <=1342-byte datagrams."""
        with self._lock:
            spots = self._deduped_pending()
        if not spots:
            return []
        now = time.time()
        need_desc = (
            now - self._descriptors_sent_at >= DESCRIPTOR_RESEND_S
            or self._packets_with_descriptors <= 3
        )
        if now - self._descriptors_sent_at >= DESCRIPTOR_RESEND_S:
            self._packets_with_descriptors = 0
        packets: list[bytes] = []
        i = 0
        while i < len(spots):
            pkt = bytearray(build_header(int(now), self._seq, self._session_id))
            if need_desc:
                pkt += DESCRIPTOR_RECEIVER
                pkt += DESCRIPTOR_SENDER_LOCATOR
                pkt += DESCRIPTOR_SENDER_NO_LOCATOR
            pkt += build_receiver_info(self.callsign, self.locator)
            added = 0
            while i < len(spots):
                rec = build_sender_record(spots[i])
                if added and len(pkt) + len(rec) > MAX_UDP_PAYLOAD_SIZE:
                    break   # record goes into the next datagram
                pkt += rec
                i += 1
                added += 1
            if added:
                packets.append(finalize_packet(pkt))
                self._seq += 1
                if need_desc:
                    self._packets_with_descriptors += 1
                    self._descriptors_sent_at = now
        return packets

    def flush(self) -> int:
        """Build + send everything pending now (used by tests/shutdown)."""
        n = 0
        for pkt in self.make_packets():
            self._send(pkt)
            n += 1
            self.count_sent += 1
        return n

    def _loop(self) -> None:  # pragma: no cover - timing loop
        from cwsl_digi_tpu_torch.utils import qos

        qos.set_current_thread_nice(qos.BEST_EFFORT)   # ≙ PSKReporter.cpp:142
        while not self._terminate:
            time.sleep(random.uniform(*SEND_PERIOD_RANGE_S))
            if self._terminate:
                return
            for pkt in self.make_packets():
                self._send(pkt)
                self.count_sent += 1
                time.sleep(INTER_PACKET_DELAY_S)
