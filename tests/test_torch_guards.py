"""Guards of the PyTorch port: neither JAX nor the JAX package in its import
graph, entry points on the card by default, no silent fallback from the
CUDA kernel to the plain version."""

from __future__ import annotations

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cwsl_digi_tpu_torch
from cwsl_digi_tpu_torch.dsp import _kernels
from cwsl_digi_tpu_torch.dsp.channelizer import BatchChannelizer

REPO = Path(__file__).resolve().parents[1]


def _port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        cwsl_digi_tpu_torch.__path__, "cwsl_digi_tpu_torch."))


def test_port_and_chip_smoke_import_without_jax():
    """Every port module, chip_smoke.py's whole import graph and the
    card-only test file load with jax and the JAX package made
    unimportable, in a fresh interpreter; an App built from a one-line FT8
    config and a receiver that starts and stops reach their lazy imports."""
    mods = _port_modules()
    assert "cwsl_digi_tpu_torch.runtime.app" in mods
    assert {f"cwsl_digi_tpu_torch.modes.{m}" for m in (
        "wspr", "jt65", "q65", "qra", "qary_engine", "rs64", "rs_device",
        "threefry")} <= set(mods)
    assert {"cwsl_digi_tpu_torch.entry", "cwsl_digi_tpu_torch.dsp.ssbd",
            "cwsl_digi_tpu_torch.utils.stringutils"} | {
        f"cwsl_digi_tpu_torch.parallel.{m}" for m in (
            "mesh", "pipeline", "timeshard", "cluster", "workers")} \
        <= set(mods)
    code = (
        "import sys, importlib, time\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cwsl_digi_tpu'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "chip_smoke._plan()\n"
        # the port's tools, which run on the machine with the card
        "sys.path.insert(0, 'tools')\n"
        "import torch_parity, torch_snr_check, torch_soak, torch_soak_merge\n"
        "import torch_bench_sections, torch_bench_ab, bench_cuda\n"
        # the card-only tests run where there is no JAX
        "sys.path.insert(0, 'tests')\n"
        "import test_torch_cuda\n"
        "from cwsl_digi_tpu_torch.config import load_config\n"
        "from cwsl_digi_tpu_torch.runtime.app import App\n"
        "from cwsl_digi_tpu_torch.runtime.receiver import Receiver\n"
        "from cwsl_digi_tpu_torch.sdr.source import open_source\n"
        "cfg = load_config(None, ['decoders.decoder=14074000 FT8'])\n"
        "app = App(cfg, device='cpu')\n"
        "app._group_lines(warn=False)\n"
        "rx = Receiver(open_source('synthetic:?sr=48000&lo=14070000'),\n"
        "              cfg.decoders, app.pool, device='cpu')\n"
        "rx.init()\n"
        "time.sleep(0.5)\n"
        "rx.terminate()\n"
        "bad = sorted(k for k, v in sys.modules.items() if v is not None and\n"
        "             k.split('.')[0] in ('jax', 'jaxlib', 'cwsl_digi_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


# files that must import neither JAX nor the JAX package: the port, the
# smoke, the port's tools and the test files that run on the machine with
# the card
_PORT_FILES = sorted(
    [p.relative_to(REPO).as_posix()
     for p in (REPO / "cwsl_digi_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py", "bench_cuda.py", "tools/torch_bench_sections.py",
       "tools/torch_decode_profile.py", "tools/torch_bench_ab.py",
       "tools/channelizer_ab.py", "tools/stage_kernels_ab.py",
       "tools/parallel_cards.py",
       "tools/torch_parity.py", "tools/torch_snr_check.py",
       "tools/torch_soak.py", "tools/torch_soak_merge.py",
       "tools/torch_ap_false.py", "tools/torch_import_tables.py",
       "tools/torch_osd_calibrate.py", "tools/torch_tune_topk.py",
       "tools/torch_wspr_calibrate.py", "tools/qra_mp_model.py",
       "tools/qra_mp_profile.py", "tools/qra_mp_variants.py",
       "tools/wspr_beam_profile.py", "tools/median_profile.py",
       "tools/sync_rs_profile.py", "tools/torch_op_chains.py",
       "tests/test_torch_cuda.py", "tests/test_torch_parity.py",
       "tests/test_torch_device_lock.py"])


def _jax_package_imports(source: str) -> list[str]:
    """Every ``import cwsl_digi_tpu...``/``from cwsl_digi_tpu... import``
    (and the same of ``jax`` or ``jaxlib``) in ``source`` (at any depth,
    inside functions too), and every ``importlib.import_module``/
    ``__import__`` of such a name."""
    def banned(name: str | None) -> bool:
        return bool(name) and name.split(".")[0] in ("cwsl_digi_tpu", "jax",
                                                    "jaxlib")

    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if banned(node.module):
                found.append(node.module)
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") \
                and banned(node.args[0].value):
            found.append(node.args[0].value)
    return found


@pytest.mark.parametrize("path", _PORT_FILES)
def test_port_files_never_import_the_jax_package(path):
    assert _jax_package_imports((REPO / path).read_text()) == []


def test_guard_accepts_a_docstring_that_names_jax():
    """The threefry module names ``jax.random`` and the reference's module
    in its docstring, which is no import."""
    src = (REPO / "cwsl_digi_tpu_torch/modes/threefry.py").read_text()
    assert "jax.random" in src and "cwsl_digi_tpu/modes/rs_device.py" in src
    assert _jax_package_imports(src) == []
    assert "import jax" not in src


@pytest.mark.parametrize("source", [
    "import cwsl_digi_tpu",
    "import numpy, cwsl_digi_tpu.constants as c",
    "from cwsl_digi_tpu import config",
    "def f():\n    from cwsl_digi_tpu.modes.gfsk import gfsk_modulate_iq",
    "import importlib\nimportlib.import_module('cwsl_digi_tpu.native')",
])
def test_import_guard_catches_jax_package_imports(source):
    assert _jax_package_imports(source)
    assert not _jax_package_imports(
        source.replace("cwsl_digi_tpu", "cwsl_digi_tpu_torch"))


@pytest.mark.parametrize("source", [
    "import jax",
    "import jax.numpy as jnp",
    "from jax import random",
    "def f():\n    from jaxlib import xla_client",
    "import importlib\nimportlib.import_module('jax.numpy')",
])
def test_import_guard_catches_jax_imports(source):
    assert _jax_package_imports(source)
    assert not _jax_package_imports(source.replace("jax", "numpy"))


def test_kernel_path_raises_without_library(monkeypatch, tmp_path):
    """A non-CPU tensor goes to the kernel; with no nvcc and no built
    library that raises instead of falling back to the plain version."""
    monkeypatch.setattr(_kernels, "_lib", None)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels.kernel_build.shutil, "which",
                        lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    before = _kernels.launches["channelize"]
    bc = BatchChannelizer(48_000, [1000.0, 7000.0], device="meta")
    iq = torch.zeros(bc._sub, dtype=torch.complex64, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        bc.process(iq)
    assert _kernels.launches["channelize"] == before


def test_kernel_wrapper_refuses_cpu_tensors(monkeypatch):
    """The wrapper checks device before launching anything, refuses a
    filter whose taps do not split into the kernel's k-steps, and refuses
    IQ or taps that the kernel's 16-byte loads cannot read."""
    monkeypatch.setattr(_kernels, "load_library", lambda: object())
    bc = BatchChannelizer(48_000, [1000.0], device="cpu")
    n_out = 256
    iq_ext = torch.zeros(bc.spec.filt_order - 4 + n_out * 4,
                         dtype=torch.complex64)
    taps = _kernels.pack_taps(bc.taps)
    rot = bc.tile_rotations(0, n_out)
    with pytest.raises(ValueError, match="kernel needs"):
        _kernels.channelize(iq_ext, taps, bc._coarse, rot, n_out, 4, 0, 1.0)
    with pytest.raises(ValueError, match="multiple of 64"):
        _kernels.channelize(iq_ext, taps[:, :3], bc._coarse, rot, n_out, 4,
                            0, 1.0)
    # a contiguous view at an odd complex64 offset is 8-byte aligned only
    buf = torch.zeros(iq_ext.numel() + 1, dtype=torch.complex64)
    _kernels._check_aligned("iq_ext", buf[:-1], 16)
    with pytest.raises(ValueError, match="16-byte alignment"):
        _kernels._check_aligned("iq_ext", buf[1:], 16)
    _kernels._check_aligned("coarse", buf[1:], 8)


def test_shared_memory_limit_is_raised_per_device(monkeypatch):
    """The kernel's shared-memory limit is raised once per device and
    larger need, and a refusal raises and leaves the limit unrecorded."""
    calls = []

    class Lib:
        refuse = False

        def channelize_allow_smem(self, smem):
            calls.append(smem)
            return 1 if self.refuse else 0

    monkeypatch.setattr(_kernels, "_smem_allowed", {})
    lib = Lib()
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    for dev, smem in [(d0, 40_000), (d0, 30_000), (d0, 50_000),
                      (d1, 30_000), (d0, 50_000)]:
        _kernels._allow_smem(lib, dev, smem)
    assert calls == [40_000, 50_000, 30_000]
    assert _kernels._smem_allowed == {0: 50_000, 1: 30_000}
    lib.refuse = True
    with pytest.raises(RuntimeError, match="shared memory"):
        _kernels._allow_smem(lib, d1, 200_000)
    assert _kernels._smem_allowed[1] == 30_000


def test_cpu_tensors_never_launch_the_kernel():
    before = _kernels.launches["channelize"]
    bc = BatchChannelizer(192_000, np.linspace(-80_000, 80_000, 4),
                          device="cpu")
    rng = np.random.default_rng(3)
    iq = (rng.standard_normal(2 * bc._sub)
          + 1j * rng.standard_normal(2 * bc._sub)).astype(np.complex64)
    bc.process(iq)
    bc.process_window(iq[: bc._sub + 16])
    assert _kernels.launches["channelize"] == before


def test_app_refuses_unported_modes():
    """No mode is refused any more: the App takes a config with all 15
    modes, and builds WSPR with ``wsprcycles`` (no -H), JT65 and Q65-30
    with ``highestdecodefreq``, as the reference's App does."""
    from cwsl_digi_tpu_torch.config import load_config
    from cwsl_digi_tpu_torch.constants import Mode
    from cwsl_digi_tpu_torch.runtime import app as app_module
    from cwsl_digi_tpu_torch.runtime.app import App

    assert not hasattr(app_module, "PORTED_MODES")
    cfg = load_config(None, [f"decoders.decoder={14_070_000 + 300 * i} "
                             f"{m.value}" for i, m in enumerate(Mode)]
                      + ["wsjtx.wsprcycles=300",
                         "wsjtx.highestdecodefreq=2500"])
    app = App(cfg, device="cpu")
    assert sorted(d.mode.value for d in app.cfg.decoders) == \
        sorted(m.value for m in Mode)
    factory = app.pool._decoder_factory
    ws = factory(Mode.WSPR)
    assert (ws.cfg.beam_width, ws.cfg.dd_passes, ws.cfg.osd_j) == (256, 1, 4)
    assert factory(Mode.JT65).spec.fmax_hz == 2500.0
    assert factory(Mode.Q65_30).spec.fmax_hz == 2500.0
    assert factory(Mode.Q65_30) is factory(Mode.Q65_30)


def test_cuda_device_helper_raises_without_cuda(monkeypatch):
    from cwsl_digi_tpu_torch import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.cuda_device()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _entry_points():
    """Each entry point that takes a device, built with no device."""
    from cwsl_digi_tpu_torch import convert
    from cwsl_digi_tpu_torch.config import load_config
    from cwsl_digi_tpu_torch.constants import Mode
    from cwsl_digi_tpu_torch.device import as_device
    from cwsl_digi_tpu_torch.entry import dryrun_multichip, entry
    from cwsl_digi_tpu_torch.modes import (base, fst4, ft4, ft8, gfsk_engine,
                                           js8, jt65, ldpc, q65, qra, wspr)
    from cwsl_digi_tpu_torch.parallel.mesh import make_mesh
    from cwsl_digi_tpu_torch.parallel.pipeline import (ShardedSkimStep,
                                                       skim_worker)
    from cwsl_digi_tpu_torch.parallel.timeshard import TimeShardedChannelizer
    from cwsl_digi_tpu_torch.parallel.workers import CardWorkers
    from cwsl_digi_tpu_torch.modes.crc import ft8_crc_matrix
    from cwsl_digi_tpu_torch.runtime.app import App
    from cwsl_digi_tpu_torch.runtime.decoderpool import DecoderPool
    from cwsl_digi_tpu_torch.runtime.receiver import Receiver
    from cwsl_digi_tpu_torch.sdr.source import open_source

    cfg = load_config(None, ["decoders.decoder=14074000 FT8"])
    return {
        "as_device": lambda: as_device(None),
        "BatchChannelizer": lambda: BatchChannelizer(48_000, [1000.0]),
        "Receiver": lambda: Receiver(
            open_source("synthetic:?sr=48000&lo=14070000"), cfg.decoders,
            DecoderPool(decoder_factory=lambda mode: None)),
        "FT8Decoder": lambda: ft8.FT8Decoder(),
        "FT4Decoder": lambda: ft4.FT4Decoder(),
        "JS8Decoder": lambda: js8.JS8Decoder(),
        "FST4Decoder": lambda: fst4.FST4Decoder("FST4-60"),
        "GFSKDecoder": lambda: gfsk_engine.GFSKDecoder(
            ft8.SPEC, ldpc.BPDecoder(ldpc.ft8_code(), device="cpu"),
            ft8_crc_matrix(), Mode.FT8, unpack=str),
        "BPDecoder": lambda: ldpc.BPDecoder(ldpc.ft8_code()),
        "WSPRDecoder": lambda: wspr.WSPRDecoder(),
        "JT65Decoder": lambda: jt65.JT65Decoder(),
        "Q65Decoder": lambda: q65.Q65Decoder(),
        "QaryMPDecoder": lambda: qra.QaryMPDecoder(q65._CODE),
        "DecoderRegistry": lambda: base.DecoderRegistry(),
        "get_decoder": lambda: base.get_decoder("FT8"),
        "get_decoder_WSPR": lambda: base.get_decoder("WSPR"),
        "get_decoder_JT65": lambda: base.get_decoder("JT65"),
        "get_decoder_Q65": lambda: base.get_decoder("Q65-30"),
        "tables_to_torch": lambda: convert.tables_to_torch(
            {"segs": np.zeros((2, 2), np.float32)}),
        "App": lambda: App(cfg),
        "make_mesh": lambda: make_mesh(),
        "make_mesh_cuda": lambda: make_mesh(devices=["cuda"]),
        "ShardedSkimStep": lambda: ShardedSkimStep(48_000, [1000.0],
                                                   make_mesh()),
        "TimeShardedChannelizer": lambda: TimeShardedChannelizer(
            48_000, [1000.0], make_mesh(axes=("t",))),
        "CardWorkers": lambda: CardWorkers(None, skim_worker, []),
        "entry": lambda: entry(),
        "dryrun_multichip": lambda: dryrun_multichip(1),
    }


@pytest.mark.parametrize("name", ["as_device", "BatchChannelizer", "Receiver",
                                  "FT8Decoder", "FT4Decoder", "JS8Decoder",
                                  "FST4Decoder", "GFSKDecoder", "BPDecoder",
                                  "WSPRDecoder", "JT65Decoder", "Q65Decoder",
                                  "QaryMPDecoder", "DecoderRegistry",
                                  "get_decoder", "get_decoder_WSPR",
                                  "get_decoder_JT65", "get_decoder_Q65",
                                  "tables_to_torch", "App", "make_mesh",
                                  "make_mesh_cuda", "ShardedSkimStep",
                                  "TimeShardedChannelizer", "CardWorkers",
                                  "entry", "dryrun_multichip"])
def test_entry_points_default_to_the_card(monkeypatch, name):
    """With no device given, every entry point asks for the card and raises
    where there is none; none falls back to the CPU."""
    build = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
