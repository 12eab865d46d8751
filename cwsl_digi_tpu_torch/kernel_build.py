"""Build the port's hand-written CUDA kernels into shared libraries.

Every kernel source under a ``csrc/`` directory of the package has a plain
C interface.  :func:`build_library` compiles one with ``nvcc`` for
``sm_90a`` into a shared library named by the source's hash (an edited
source rebuilds), in a build directory beside it; the caller loads it with
ctypes.  Nothing is built when a module is imported: the CPU tests import
every module on machines with no ``nvcc``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_library(src: Path, build_dir: Path, stem: str,
                  extra_flags: tuple[str, ...] = ()) -> tuple[Path, str | None]:
    """Compile ``src`` into ``build_dir/lib<stem>_<hash>.so`` unless that
    build exists.  Returns the library's path and nvcc's output (``None``
    when the library was already built); raises if nvcc fails."""
    flags = [*NVCC_FLAGS, *extra_flags]
    digest = hashlib.sha256(src.read_bytes())
    if extra_flags:
        digest.update(" ".join(extra_flags).encode())
    out = build_dir / f"lib{stem}_{digest.hexdigest()[:12]}.so"
    if out.exists():
        return out, None
    compiler = nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src.name}:\n"
                           f"{log}")
    os.replace(tmp, out)
    return out, log
