"""Decode saved FT8 channel-windows alone through the port.

``tools/torch_soak.py --keep-false DIR`` saves each live channel-window
with a decode that was never injected (float32 ``.npy`` plus a JSON
sidecar with the decoder's construction kwargs and the live decode's
messages).  This tool decodes each of them again, alone, through
``get_decoder`` on ``--device``, fed as a tensor on that device (as the
live path feeds it, so nothing is peak-scaled), and once more beside a
companion window that holds one strong burst.  A window's decode list can
depend on its batch: the pass loop runs a later pass for the whole batch
when any window had a decode, so the companion shows whether the live
false message needs one.

Usage (the card by default)::

    python tools/torch_ap_false.py chiprun_out/ap_false
    python tools/torch_ap_false.py tests/torch_fixtures/ap_false --device cpu

It prints one JSON line per window and writes ``decodes_<device>.json``
in the directory.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

# the companion's burst: a message no live run injects, at 1 kHz, strong
COMPANION = "K1ABC W9XYZ EN37"


def fixtures(directory: str | Path) -> list[tuple[Path, dict]]:
    """(window path, sidecar) of every saved window in ``directory``."""
    return [(p.with_suffix(".npy"), json.loads(p.read_text()))
            for p in sorted(Path(directory).glob("*.json"))
            if p.with_suffix(".npy").exists()]


def decode_window(audio: np.ndarray, sidecar: dict, device,
                  companion: bool = False, decoders: dict | None = None
                  ) -> list[str]:
    """The sorted messages the port decodes in ``audio`` (float32 [N]) with
    the sidecar's decoder, alone or beside the companion window."""
    from cwsl_digi_tpu_torch.modes import ft8
    from cwsl_digi_tpu_torch.modes.base import get_decoder

    kwargs = sidecar["decoder"]
    key = (sidecar["mode"],) + tuple(sorted(kwargs.items()))
    decoders = {} if decoders is None else decoders
    if key not in decoders:
        decoders[key] = get_decoder(sidecar["mode"], device=device, **kwargs)
    windows = [np.asarray(audio, np.float32)]
    if companion:
        peak = float(np.abs(windows[0]).max())
        windows.append(peak * ft8.synthesize(COMPANION, 1000.0)[
            : len(windows[0])].astype(np.float32))
    batch = torch.from_numpy(np.stack(windows)).to(device)
    return sorted(r.message for r in decoders[key].decode(batch)[0])


def main(argv: list[str] | None = None) -> list[dict]:
    from torch_parity import device_line, tool_device

    ap = argparse.ArgumentParser()
    ap.add_argument("directory")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    dev = tool_device(args.device)
    decoders: dict = {}
    rows = []
    for path, side in fixtures(args.directory):
        audio = np.load(path)
        row = {"window": path.name, "false": side["false"],
               "live": sorted(side["messages"]),
               "alone": decode_window(audio, side, dev, decoders=decoders),
               "with_companion": decode_window(audio, side, dev, True,
                                               decoders)}
        row["false_alone"] = [m for m in side["false"] if m in row["alone"]]
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = Path(args.directory) / f"decodes_{dev.type}.json"
    out.write_text(json.dumps({"card": device_line(dev), "device": str(dev),
                               "windows": rows}, indent=1))
    print(f"wrote {out}")
    return rows


if __name__ == "__main__":
    main()
