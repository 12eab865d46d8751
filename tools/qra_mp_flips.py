"""Which way the GF(64) message passing's flags move with the order of its
sums: the words of the smoke's 64-window Q65-30 weak replay (7,680 with
the decoder's 24 candidates and 5 prior variants) through the ``qra_mp``
kernel, the plain version (``decode_plain``, its transforms [64, 64]
matmuls) on the card and on the CPU, the NumPy model of the kernel's
arithmetic (``tools/qra_mp_model.py``) and the JAX package.

    python tools/qra_mp_flips.py card [--windows 64] [--out DIR] [--device D]
    JAX_PLATFORMS=cpu python tools/qra_mp_flips.py cpu DIR

``card`` decodes the windows on the card, keeps the energies ``e`` the
decoder hands ``_mp_priors`` and the candidates' metadata, makes the
priors from them on the CPU (so that a later ``cpu`` run reads the same
words), runs the kernel, the plain version on both devices and the model
(in worker processes), prints the comparisons and saves ``e``, the
metadata and each run's results to ``DIR/flips.npz`` (~30 MB).  It also
holds the kernel against the plain version on the priors the decoder made
on the card, the smoke's check.  ``cpu`` reads that file, runs the JAX
package and the plain version on this CPU, checks that the model gives
here what it gave on the card's host (the first 240 words), prints
every pair again and saves the JAX package's results to ``DIR/jax.npz``
(``tools/qra_mp_variants.py`` reads them).  Only ``cpu`` imports JAX.

For each pair A vs B it prints each side's converged words (the syndrome
holds), the flags that differ split into the words A loses (B converges,
A does not) and A gains, the sign test's z of that split, the symbols
that differ where both converge, the largest confidence difference there,
and whether the decoder's lists from the two runs are equal.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cwsl_digi_tpu_torch.modes import q65, qary_engine, qra  # noqa: E402

META = ("score", "t0_hop", "f0_bin", "snr")
MODEL_CHUNK = 240


def _model_chunk(pr: np.ndarray):
    """The NumPy model of ``qra_mp`` on one chunk (a worker process)."""
    from qra_mp_model import mp_model

    return mp_model(q65._mp(torch.device("cpu")), pr)


def run_model(pr: np.ndarray, workers: int) -> tuple:
    """The model on every word, in chunks over ``workers`` processes."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    chunks = [pr[i : i + MODEL_CHUNK] for i in range(0, len(pr), MODEL_CHUNK)]
    with ProcessPoolExecutor(workers,
                             mp_context=mp.get_context("spawn")) as pool:
        parts = list(pool.map(_model_chunk, chunks))
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(3))


def priors(e: np.ndarray) -> np.ndarray:
    """The decoder's message-passing words [M, 63, 64] of ``e`` on the
    CPU."""
    return qary_engine._mp_priors(qary_engine.QaryDecoder.MP_VARIANTS,
                                  torch.from_numpy(e)).reshape(
        -1, 63, 64).numpy()


def plain(pr: np.ndarray, device: str) -> tuple:
    """``decode_plain`` on ``device`` in chunks of 960 words."""
    mp = q65._mp(torch.device(device))
    parts = []
    for i in range(0, len(pr), 960):
        x = torch.from_numpy(pr[i : i + 960]).to(device)
        parts.append([t.cpu().numpy() for t in mp.decode_plain(x)])
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(3))


def decode_lists(saved: dict, hard: np.ndarray, ok: np.ndarray) -> list:
    """The decoder's per-window lists from these message-passing
    results."""
    dec = q65.Q65Decoder(device="cpu")
    e = saved["e"]
    b, k = e.shape[:2]
    n_var = len(dec.MP_VARIANTS)
    packed = qary_engine._mp_score_pack(
        dec.soft_accept, torch.from_numpy(e),
        torch.from_numpy(hard.reshape(b, k, n_var, -1).astype(np.int64)),
        torch.from_numpy(ok.reshape(b, k, n_var)),
        *(torch.from_numpy(saved[m]) for m in META)).numpy()
    n = e.shape[2]
    meta = {"score": packed[:, :, n + 1],
            "t0_hop": packed[:, :, n + 2].astype(np.int64),
            "f0_bin": packed[:, :, n + 3].astype(np.int64),
            "snr": packed[:, :, n + 4]}
    res = dec._results(b, k, packed[:, :, n] > 0.5,
                       packed[:, :, : dec.mp.code.k].astype(np.int64), meta)
    return [[(r.message, r.snr_db, r.dt_s, r.freq_hz, r.score) for r in w]
            for w in res]


def compare(runs: dict, saved: dict | None, pairs) -> None:
    """Print each pair's flags, their split and the symbols where both
    converge."""
    print(f"{len(next(iter(runs.values()))[1])} words; converged: "
          + ", ".join(f"{k} {int(v[1].sum())}" for k, v in runs.items()))
    lists = ({k: decode_lists(saved, v[0], v[1]) for k, v in runs.items()}
             if saved is not None else {})
    for a, b in pairs:
        (ha, oa, ca), (hb, ob, cb) = runs[a], runs[b]
        both = oa & ob
        lost, gained = int((ob & ~oa).sum()), int((oa & ~ob).sum())
        z = (lost - gained) / np.sqrt(lost + gained) if lost + gained else 0.0
        diff = np.abs(ca - cb)[both]
        line = (f"{a} vs {b}: flags differ {lost + gained} ({a} loses "
                f"{lost}, gains {gained}; z {z:+.2f}), converged by both "
                f"{int(both.sum())}, symbols differ there "
                f"{int((ha != hb).any(-1)[both].sum())}, confidence there "
                f"max |diff| {float(diff.max()) if diff.size else 0.0:.4g}")
        if lists:
            line += f", decode lists equal {lists[a] == lists[b]}"
        print(line)


def bits_equal(x: tuple, y: tuple) -> bool:
    """(hard, ok, conf) identical, conf bit for bit."""
    return (np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
            and np.array_equal(np.asarray(x[2], np.float32).view(np.uint32),
                               np.asarray(y[2], np.float32).view(np.uint32)))


def card(n_win: int, out_dir: Path, device: str) -> int:
    import chip_smoke

    dev = torch.device(device)
    wins = torch.from_numpy(
        chip_smoke._weak_windows("Q65-30", n_win, chip_smoke.SEED + 63)
    ).to(dev)
    rec = {}
    decode_mp = qary_engine.QaryDecoder._decode_mp
    mp_decode = qra.QaryMPDecoder.decode

    def keep_out(self, out):
        rec["out"] = {k: out[k].cpu().numpy() for k in ("e",) + META}
        return decode_mp(self, out)

    def keep_probs(self, probs):
        rec["card_priors"] = probs.clone()
        return mp_decode(self, probs)

    qary_engine.QaryDecoder._decode_mp = keep_out
    qra.QaryMPDecoder.decode = keep_probs
    try:
        res = q65.Q65Decoder(device=dev).decode(wins)
    finally:
        qary_engine.QaryDecoder._decode_mp = decode_mp
        qra.QaryMPDecoder.decode = mp_decode
    print(f"{sum(len(r) for r in res)} decodes in {n_win} windows")
    saved = rec["out"]
    mp = q65._mp(dev)

    # the smoke's words: the priors the decoder made on the card
    cp = rec["card_priors"]
    compare({"kernel": tuple(t.cpu().numpy() for t in mp.decode(cp)),
             "plain card": tuple(t.cpu().numpy()
                                 for t in mp.decode_plain(cp))},
            saved, [("kernel", "plain card")])

    # the same words everywhere: the priors made on the CPU
    pr = priors(saved["e"])
    cp_np = cp.cpu().numpy()
    print(f"priors made on the CPU vs on the card: "
          f"{int((pr.view(np.uint32) != cp_np.view(np.uint32)).sum())} of "
          f"{pr.size} entries differ, max |diff| "
          f"{float(np.abs(pr - cp_np).max()):.3g}")
    x = torch.from_numpy(pr).to(dev)
    runs = {"kernel": tuple(t.cpu().numpy() for t in mp.decode(x)),
            "plain card": plain(pr, device),
            "plain cpu": plain(pr, "cpu")}
    runs["model"] = run_model(pr, max(1, min(8, os.cpu_count() or 1) - 1))
    print(f"kernel and model bit for bit (hard, ok, conf): "
          f"{bits_equal(runs['kernel'], runs['model'])}")
    compare(runs, saved, [("kernel", "model"), ("kernel", "plain card"),
                          ("model", "plain cpu"), ("plain card", "plain cpu")])
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / "flips.npz", **saved,
             **{f"{k.replace(' ', '_')}_{f}":
                v[i].astype(np.uint8) if f == "hard" else v[i]
                for k, v in runs.items()
                for i, f in enumerate(("hard", "ok", "conf"))})
    return 0


def cpu(path: Path) -> int:
    import jax.numpy as jnp
    from qra_mp_model import mp_model

    from cwsl_digi_tpu.modes import q65 as jq65

    torch.set_num_threads(4)
    z = np.load(path / "flips.npz")
    saved = {k: z[k] for k in ("e",) + META}
    runs = {k: tuple(z[f"{k.replace(' ', '_')}_{f}"].astype(np.int64)
                     if f == "hard" else z[f"{k.replace(' ', '_')}_{f}"]
                     for f in ("hard", "ok", "conf"))
            for k in ("kernel", "model", "plain card", "plain cpu")}
    runs["plain card-host cpu"] = runs.pop("plain cpu")
    pr = priors(saved["e"])
    mine = mp_model(q65._mp(torch.device("cpu")), pr[:MODEL_CHUNK])
    print("the model here as on the card's host (first "
          f"{MODEL_CHUNK} words, bit for bit): "
          f"{bits_equal(mine, tuple(v[:MODEL_CHUNK] for v in runs['model']))}")
    runs["plain cpu"] = plain(pr, "cpu")
    mp = jq65._mp()
    parts = []
    for i in range(0, len(pr), 960):
        parts.append([np.array(t) for t in mp.decode(jnp.asarray(
            pr[i : i + 960]))])
    runs["jax"] = tuple(np.concatenate([p[i] for p in parts])
                        for i in range(3))
    runs["jax"] = (runs["jax"][0].astype(np.int64),) + runs["jax"][1:]
    np.savez(path / "jax.npz", **dict(zip(("jax_hard", "jax_ok", "jax_conf"),
                                          runs["jax"])))
    compare(runs, saved, [("kernel", "model"), ("model", "plain cpu"),
                          ("plain cpu", "jax"), ("model", "jax"),
                          ("kernel", "jax"),
                          ("kernel", "plain card"), ("plain card", "jax"),
                          ("plain cpu", "plain card-host cpu")])
    return 0


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="where", required=True)
    c = sub.add_parser("card")
    c.add_argument("--windows", type=int, default=64)
    c.add_argument("--out", type=Path, default=ROOT / "chiprun_out")
    c.add_argument("--device", default="cuda:0",
                   help="cpu for a dry run of the tool at a few windows")
    h = sub.add_parser("cpu")
    h.add_argument("dir", type=Path)
    a = ap.parse_args(argv)
    if a.where == "card":
        return card(a.windows, a.out, a.device)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    return cpu(a.dir)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
