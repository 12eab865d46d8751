"""Guards of the PyTorch port: no JAX in its import graph, no silent
fallback from the CUDA kernel to the plain version."""

from __future__ import annotations

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
    card-only test file load with jax made unimportable, in a fresh
    interpreter."""
    mods = _port_modules()
    assert "cwsl_digi_tpu_torch.runtime.app" in mods
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "chip_smoke._plan()\n"
        # the card-only tests run where there is no JAX
        "sys.path.insert(0, 'tests')\n"
        "import test_torch_cuda\n"
        # the lazily imported parts of the smoke's main path
        "from cwsl_digi_tpu.config import load_config\n"
        "from cwsl_digi_tpu.modes.gfsk import gfsk_modulate_iq\n"
        "from cwsl_digi_tpu.report.spot import extract_spot\n"
        "assert not any(k == 'jax' or k.startswith('jax.') or k == 'jaxlib'\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_kernel_path_raises_without_library(monkeypatch, tmp_path):
    """A non-CPU tensor goes to the kernel; with no nvcc and no built
    library that raises instead of falling back to the plain version."""
    monkeypatch.setattr(_kernels, "_lib", None)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    before = _kernels.launches["channelize"]
    bc = BatchChannelizer(48_000, [1000.0, 7000.0], device="meta")
    iq = torch.zeros(bc._sub, dtype=torch.complex64, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        bc.process(iq)
    assert _kernels.launches["channelize"] == before


def test_kernel_wrapper_refuses_cpu_tensors(monkeypatch):
    """The wrapper checks device before launching anything."""
    monkeypatch.setattr(_kernels, "load_library", lambda: object())
    bc = BatchChannelizer(48_000, [1000.0])
    n_out = 256
    iq_ext = torch.zeros(bc.spec.filt_order - 4 + n_out * 4,
                         dtype=torch.complex64)
    rot = bc._rotations(0, 1024, 1)
    with pytest.raises(ValueError, match="kernel needs"):
        _kernels.channelize(iq_ext, bc._coarse, bc._fine, rot, bc._filt,
                            n_out, 0, 1.0)


def test_cpu_tensors_never_launch_the_kernel():
    before = _kernels.launches["channelize"]
    bc = BatchChannelizer(192_000, np.linspace(-80_000, 80_000, 4))
    rng = np.random.default_rng(3)
    iq = (rng.standard_normal(2 * bc._sub)
          + 1j * rng.standard_normal(2 * bc._sub)).astype(np.complex64)
    bc.process(iq)
    bc.process_window(iq[: bc._sub + 16])
    assert _kernels.launches["channelize"] == before


def test_app_refuses_unported_modes():
    from cwsl_digi_tpu.config import load_config
    from cwsl_digi_tpu_torch.runtime.app import App

    cfg = load_config(None, ["decoders.decoder=14074000 FT8",
                             "decoders.decoder=14080000 FT4"])
    with pytest.raises(ValueError, match="FT4"):
        App(cfg, device="cpu")


def test_cuda_device_helper_raises_without_cuda(monkeypatch):
    from cwsl_digi_tpu_torch import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.cuda_device()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
