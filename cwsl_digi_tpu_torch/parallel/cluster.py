"""Multi-host distribution over DCN: window dispatch + spot aggregation.

The reference is strictly single-host (SURVEY.md §2.4); the TPU build scales
out with two complementary mechanisms:

1. **Intra-program sharding** (mesh.py / pipeline.py / timeshard.py): one
   jitted program spanning all chips of a slice — XLA moves tensors over
   ICI.  For multi-host slices the same code runs under
   ``jax.distributed.initialize()``; nothing here changes.

2. **Window-level dispatch over DCN** (this module): independent capture
   windows are embarrassingly parallel, so hosts that don't share a slice
   cooperate at the DecodeJob level:

   - :class:`WindowServer` — accepts length-prefixed (header JSON + raw
     audio) capture windows from remote feeders and pushes them into the
     local DecoderPool;
   - :class:`WindowClient` — the feeder side, used by a host whose SDR
     ingest outpaces its own chips;
   - :class:`SpotForwarder` / :class:`SpotAggregator` — decoded spots from
     worker hosts stream back to the single reporting host as JSON lines,
     which then applies the normal dedupe + PSK Reporter/WSPRNet/RBN path
     (reporting must be centralized — the wire protocols assume one
     station identity).
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
from typing import Callable, Optional

import numpy as np
import torch

from cwsl_digi_tpu_torch.constants import Mode
from cwsl_digi_tpu_torch.report.spot import Spot
from cwsl_digi_tpu_torch.runtime.decoderpool import DecodeJob

_MAGIC = b"CWTW"   # window frames
_MAGICS = b"CWTS"  # spot frames


def _send_frame(sock: socket.socket, magic: bytes, header: dict,
                payload: bytes = b"") -> None:
    h = json.dumps(header).encode()
    sock.sendall(magic + struct.pack(">II", len(h), len(payload)) + h + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket, magic: bytes) -> tuple[dict, bytes]:
    m = _recv_exact(sock, 4)
    if m != magic:
        raise ConnectionError(f"bad frame magic {m!r}")
    hlen, plen = struct.unpack(">II", _recv_exact(sock, 8))
    header = json.loads(_recv_exact(sock, hlen))
    payload = _recv_exact(sock, plen) if plen else b""
    return header, payload


# ---------------------------------------------------------------------------
# Window dispatch
# ---------------------------------------------------------------------------

class WindowClient:
    """Feeder: send DecodeJobs to a remote decode host."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port), timeout=10.0)

    def send(self, job: DecodeJob) -> None:
        audio = job.audio
        if isinstance(audio, torch.Tensor):     # device windows to the host
            audio = audio.cpu().numpy()
        audio = np.ascontiguousarray(audio, np.float32)
        header = {
            "mode": job.mode.value,
            "shape": list(audio.shape),
            "base_freqs": list(map(int, job.base_freqs)),
            "decoder_indices": list(map(int, job.decoder_indices)),
            "epoch_time": int(job.epoch_time),
            "wspr_callsigns": job.wspr_callsigns or [],
        }
        _send_frame(self._sock, _MAGIC, header, audio.tobytes())

    def close(self) -> None:
        self._sock.close()


class WindowServer:
    """Decode host: receive windows, push to the local pool."""

    def __init__(self, port: int, pool, host: str = "0.0.0.0"):
        self.pool = pool
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):  # one connection = a stream of frames
                while True:
                    try:
                        header, payload = _recv_frame(self.request, _MAGIC)
                    except (ConnectionError, OSError):
                        return
                    audio = np.frombuffer(payload, np.float32).reshape(
                        header["shape"])
                    outer.pool.push(DecodeJob(
                        mode=Mode(header["mode"]),
                        audio=audio.copy(),
                        base_freqs=header["base_freqs"],
                        decoder_indices=header["decoder_indices"],
                        epoch_time=header["epoch_time"],
                        wspr_callsigns=header.get("wspr_callsigns") or None,
                    ))
                    outer.count_received += 1

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.count_received = 0
        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever,
                         name="window-server", daemon=True).start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


# ---------------------------------------------------------------------------
# Spot aggregation
# ---------------------------------------------------------------------------

def _spot_to_dict(spot: Spot) -> dict:
    d = dict(spot.__dict__)
    d["mode"] = spot.mode.value
    return d


def _spot_from_dict(d: dict) -> Spot:
    d = dict(d)
    d["mode"] = Mode(d["mode"])
    return Spot(**d)


class SpotForwarder:
    """Reporter-shaped client: forwards spots to the aggregation host."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port), timeout=10.0)
        self._lock = threading.Lock()

    def handle(self, spot: Spot) -> None:
        with self._lock:
            _send_frame(self._sock, _MAGICS, _spot_to_dict(spot))

    def terminate(self) -> None:
        self._sock.close()


class SpotAggregator:
    """Reporting host: receives remote spots into the local SpotHandler path."""

    def __init__(self, port: int, on_spot: Callable[[Spot], None],
                 host: str = "0.0.0.0"):
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        header, _ = _recv_frame(self.request, _MAGICS)
                    except (ConnectionError, OSError):
                        return
                    outer.on_spot(_spot_from_dict(header))
                    outer.count_received += 1

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.on_spot = on_spot
        self.count_received = 0
        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever,
                         name="spot-aggregator", daemon=True).start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
