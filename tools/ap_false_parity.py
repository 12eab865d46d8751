"""Hold saved live FT8 windows against the JAX package, on the CPU.

For each window that ``tools/torch_soak.py --keep-false DIR`` saved, it
decodes the window alone in the JAX package (``FT8Decoder`` with the
sidecar's kwargs, fed a ``jnp`` array) and in the port on the CPU (fed a
tensor: neither peak-scales), reads the card's list from
``DIR/decodes_cuda.json`` (``tools/torch_ap_false.py`` on the card) where
there is one, and prints one JSON line per window with ``same`` true when
all lists agree message for message.  It imports both packages, so it
runs where JAX does, not on the card.

Usage::

    JAX_PLATFORMS=cpu python tools/ap_false_parity.py chiprun_out/ap_false
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))


def main(argv: list[str] | None = None) -> list[dict]:
    import jax.numpy as jnp

    from cwsl_digi_tpu.modes.base import get_decoder as jax_decoder
    from torch_ap_false import decode_window, fixtures

    directory = Path((argv or sys.argv[1:])[0])
    card_file = directory / "decodes_cuda.json"
    card = ({w["window"]: w["alone"] for w in
             json.loads(card_file.read_text())["windows"]}
            if card_file.exists() else {})
    port_decoders: dict = {}
    rows = []
    for path, side in fixtures(directory):
        audio = np.load(path)
        dec = jax_decoder(side["mode"], **side["decoder"])
        jax = sorted(r.message
                     for r in dec.decode(jnp.asarray(audio)[None])[0])
        port = decode_window(audio, side, torch.device("cpu"),
                             decoders=port_decoders)
        row = {"window": path.name, "false": side["false"], "jax": jax,
               "port_cpu": port, "port_cuda": card.get(path.name)}
        row["same"] = jax == port and row["port_cuda"] in (None, jax)
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(f"{sum(r['same'] for r in rows)} of {len(rows)} windows decode the "
          "same list in every package")
    return rows


if __name__ == "__main__":
    main()
