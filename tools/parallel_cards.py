"""The port's parallel layer across the cards of one host.

    python3 tools/parallel_cards.py          # every visible CUDA card
    python3 tools/parallel_cards.py --cpu 4  # rehearsal: CPU entries, gloo

1. ``one_process``: in one process, the channel-sharded skim of the
   smoke's 64 FT8 dials (192 kHz, bursts in 8) on meshes of 1, 2 and all
   cards, each held to the 1-card mesh's decodes and timed (median of the
   steps); the 1-card mesh runs in this process, the others a worker
   process a card (``parallel/workers.py``), whose start-up (spawn,
   build, warm-up) is timed apart from the steps, and each step's wall
   is split into the parent's write of the window, the slowest worker's
   own time and the rest (the handover).  Then one 900 s window (4
   channels) time-sharded over the same meshes (a host thread a card),
   held to the 1-card output and timed.
2. ``nccl``: one process per card under an NCCL process group of world
   size = the card count (``tcp://localhost``): the skim, each rank on its
   own card's rows (``local_channels`` must cover every channel once, the
   bursts decode on their channels only), timed between barriers; and a
   120 s window time-sharded one shard a rank, each rank's span held to
   its own card's whole-window channelizer.

Prints the card line, one JSON line per part, a ``skim_walls_s`` line
with the one-process walls beside the NCCL ranks' wall, then ``{"ok":
true, ...}``.  With ``--cpu N`` the entries are CPU devices (N of them;
a CPU mesh runs in this process, so the one-process part takes no pool
there: ``tests/test_torch_workers.py`` covers it), the skim runs once,
the long windows are 15 s and the process group is gloo.
"""

from __future__ import annotations

import argparse
import json
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as smoke  # noqa: E402

LONG_S = 900          # the threads part's time-sharded window (s)
LONG_S_NCCL = 120     # the nccl part's (each rank builds it on its host)


def _sync(devices) -> None:
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def _long_iq(seconds: int) -> tuple[np.ndarray, np.ndarray]:
    from cwsl_digi_tpu_torch.entry import long_window_iq

    dials, _ = smoke._plan()
    tfreqs = (np.asarray(dials, np.float64) - smoke.LO)[[8, 24, 40, 56]]
    mode = "FST4W-900" if seconds >= 900 else "FST4W-120"
    iq = long_window_iq(smoke.FS, seconds * smoke.FS, mode, "K1ABC FN42 30",
                        tfreqs[1] + 1500, 0.01, 0.05 / np.sqrt(2),
                        np.random.default_rng(smoke.SEED))
    return tfreqs, iq


def _timed_step(step, iq, devices, times: dict) -> dict:
    """One step, its wall appended to ``times["walls_s"]``; for a pool
    also the parent's write of the window and the slowest worker's own
    seconds (the rest of the wall is the handover: messages, the
    results through the pipes)."""
    _sync(devices)
    t = time.monotonic()
    res = step.step(iq)
    times.setdefault("walls_s", []).append(time.monotonic() - t)
    if step.workers is not None:
        times.setdefault("write_s", []).append(step.workers.write_s)
        times.setdefault("worker_s", []).append(max(step.workers.worker_s))
    return res


def _medians(times: dict) -> dict:
    out = {k.replace("walls_s", "wall_s"): statistics.median(v)
           for k, v in times.items()}
    if "worker_s" in times:
        out["handover_s"] = statistics.median(
            w - a - b for w, a, b in zip(times["walls_s"], times["write_s"],
                                         times["worker_s"]))
    return out


def one_process_part(devices: list[torch.device], reps: int,
                     long_s: int) -> dict:
    from cwsl_digi_tpu_torch.parallel.mesh import make_mesh
    from cwsl_digi_tpu_torch.parallel.pipeline import ShardedSkimStep
    from cwsl_digi_tpu_torch.parallel.timeshard import TimeShardedChannelizer

    freqs, iq, want = smoke.skim_window()
    counts = sorted({1, min(2, len(devices)), len(devices)})
    out: dict = {"skim": {}, "timeshard": {}}
    ref = None
    for k in counts:
        t = time.monotonic()
        step = ShardedSkimStep(smoke.FS, freqs, make_mesh(
            k, devices=devices[:k]))
        start_s = time.monotonic() - t
        times = {}
        try:
            step.step(iq)                               # warm-up
            for _ in range(reps):
                res = _timed_step(step, iq, devices, times)
        finally:
            step.close()
        got = smoke.skim_decodes(step, res)
        if got != want:
            raise AssertionError(f"skim on {k} entries decodes {got}")
        if ref is None:
            ref = res
        elif not smoke.same_decodes(res, ref):
            raise AssertionError(f"skim on {k} entries disagrees with 1")
        pool = step.workers
        out["skim"][k] = {
            **_medians(times), **times,
            "workers": None if pool is None else len(pool.devices),
            "start_s": start_s,
            "worker_start_s": None if pool is None else pool.start_s}
        m = _medians(times)
        print(f"one-process skim, {k} entries of {64 // k} channels "
              f"({'in this process' if pool is None else 'a worker each'}):"
              f" median {m['wall_s']:.4f} s {times['walls_s']}"
              + ("" if pool is None else
                 f" (write {m['write_s']:.4f} s, slowest worker "
                 f"{m['worker_s']:.4f} s, handover {m['handover_s']:.4f} s)")
              + f"; start-up {start_s:.2f} s", flush=True)
    tfreqs, iq_long = _long_iq(long_s)
    ref = None
    for k in counts:
        if long_s * smoke.FS % (16 * k):
            continue
        tsc = TimeShardedChannelizer(smoke.FS, tfreqs, make_mesh(
            k, axes=("t",), devices=devices[:k]))
        tsc.channelize(iq_long)                          # warm-up
        walls = []
        for _ in range(reps):
            _sync(devices)
            t = time.monotonic()
            audio = tsc.channelize(iq_long)
            _sync(devices)
            walls.append(time.monotonic() - t)
        audio = audio.cpu()
        err = 0.0 if ref is None else float((audio - ref).abs().max())
        if ref is None:
            ref = audio
        if not err <= smoke.CHAN_TOL:
            raise AssertionError(f"time shards on {k} entries: err {err}")
        out["timeshard"][k] = {"wall_s": statistics.median(walls),
                               "walls_s": walls, "max_abs_err_vs_1": err}
        print(f"threads time shard, {long_s} s over {k} entries: median "
              f"{statistics.median(walls):.3f} s {walls}, max abs err vs "
              f"1 entry {err:.3g}", flush=True)
    return out


def rank_main(rank: int, world: int, port: int, cpu: bool, reps: int,
              long_s: int) -> None:
    """One rank of the nccl part (gloo on the CPU)."""
    import torch.distributed as dist

    from cwsl_digi_tpu_torch.dsp.channelizer import BatchChannelizer
    from cwsl_digi_tpu_torch.parallel.mesh import make_mesh
    from cwsl_digi_tpu_torch.parallel.pipeline import ShardedSkimStep
    from cwsl_digi_tpu_torch.parallel.timeshard import TimeShardedChannelizer

    if cpu:
        dev = torch.device("cpu")
        torch.set_num_threads(2)
    else:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        devices = ["cpu"] if cpu else None
        freqs, iq, want = smoke.skim_window()
        step = ShardedSkimStep(smoke.FS, freqs, make_mesh(
            axes=("ch",), devices=devices))
        step.step(iq)                                   # warm-up
        walls = []
        for _ in range(reps):
            _sync([dev])
            dist.barrier()
            t = time.monotonic()
            res = step.step(iq)
            _sync([dev])
            dist.barrier()
            walls.append(time.monotonic() - t)
        got = smoke.skim_decodes(step, res)
        tfreqs, iq_long = _long_iq(long_s)
        tsc = TimeShardedChannelizer(smoke.FS, tfreqs, make_mesh(
            axes=("t",), devices=devices))
        tsc.channelize(iq_long)                          # warm-up
        dist.barrier()
        t = time.monotonic()
        audio = tsc.channelize(iq_long)
        _sync([dev])
        dist.barrier()
        t_wall = time.monotonic() - t
        lo, hi = tsc.local_span
        whole = BatchChannelizer(smoke.FS, tfreqs, device=dev).process_window(
            torch.from_numpy(iq_long).to(dev))
        err = float((audio - whole[:, lo:hi]).abs().max())
        print("RESULT " + json.dumps({
            "rank": rank, "device": str(dev), "local": step.local_channels,
            "decodes": {str(c): m for c, m in got.items()},
            "want": {str(c): m for c, m in want.items()
                     if c in step.local_channels},
            "skim_walls_s": walls, "timeshard_wall_s": t_wall,
            "span": [lo, hi], "n_out": whole.shape[1], "err": err}),
            flush=True)
    finally:
        dist.destroy_process_group()


def nccl_part(world: int, cpu: bool, reps: int, long_s: int) -> dict:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    args = ["--world", str(world), "--port", str(port), "--reps", str(reps),
            "--long-s", str(long_s)] + (["--cpu", str(world)] if cpu else [])
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r)] + args,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=900)
            if p.returncode != 0:
                raise RuntimeError(f"rank failed ({p.returncode}):\n"
                                   f"{text[-4000:]}")
            outs.append(json.loads([ln for ln in text.splitlines()
                                    if ln.startswith("RESULT ")][-1][7:]))
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=60)
    local = sorted(c for o in outs for c in o["local"])
    if local != list(range(64)):
        raise AssertionError(f"local channels {local}")
    for o in outs:
        if o["decodes"] != o["want"]:
            raise AssertionError(f"rank {o['rank']} decodes {o['decodes']}, "
                                 f"want {o['want']}")
    n_out = outs[0]["n_out"]
    spans = [o["span"] for o in outs]
    if spans != [[r * n_out // world, (r + 1) * n_out // world]
                 for r in range(world)] \
            or not max(o["err"] for o in outs) <= smoke.CHAN_TOL:
        raise AssertionError(f"time-shard spans {spans}, errors "
                             f"{[o['err'] for o in outs]}")
    walls = [max(w) for w in zip(*(o["skim_walls_s"] for o in outs))]
    res = {"world": world, "skim_wall_s": statistics.median(walls),
           "skim_walls_s": walls,
           "timeshard_wall_s": max(o["timeshard_wall_s"] for o in outs),
           "max_abs_err": max(o["err"] for o in outs),
           "devices": [o["device"] for o in outs]}
    print(f"nccl skim, world {world}: median {res['skim_wall_s']:.3f} s "
          f"{walls}; time shard {long_s} s in {res['timeshard_wall_s']:.3f} "
          f"s, max abs err {res['max_abs_err']:.3g}", flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", type=int, default=0,
                    help="rehearse on this many CPU entries (gloo)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--reps", type=int, default=3,
                    help="timed steps a mesh on the cards (default 3)")
    ap.add_argument("--long-s", type=int, default=0, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.rank is not None:
        rank_main(a.rank, a.world, a.port, a.cpu > 0, a.reps, a.long_s)
        return 0
    if a.cpu:
        devices = [torch.device("cpu")] * a.cpu
        reps, long_s, long_s_nccl = 1, 15, 15
    else:
        print(smoke.card_line(), flush=True)
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        reps, long_s, long_s_nccl = a.reps, LONG_S, LONG_S_NCCL
    t = time.monotonic()
    one = one_process_part(devices, reps, long_s)
    print(json.dumps({"one_process": one}), flush=True)
    nccl = nccl_part(len(devices), a.cpu > 0, reps, long_s_nccl)
    print(json.dumps({"nccl": nccl}), flush=True)
    print(json.dumps({"skim_walls_s": {
        "one_process": {k: v["wall_s"] for k, v in one["skim"].items()},
        "nccl_ranks": {nccl["world"]: nccl["skim_wall_s"]}}}), flush=True)
    print(f"wall {time.monotonic() - t:.1f} s")
    kind = "cpu" if a.cpu else torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "cpu" if a.cpu else "gpu", "kind": kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
