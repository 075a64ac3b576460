"""Build a CUDA source of this package into a plain-C shared library with nvcc.

The library goes to `quadruped_tpu_torch/_build/` (listed in .gitignore),
named by a hash of the source and flags, so a changed source builds anew
and an unchanged one is built once per checkout. Nothing here runs at
import time; the kernel wrappers call `build_shared_library` at their first
launch.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """nvcc from PATH, else from $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if not candidate.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {candidate}")
    return str(candidate)


def build_shared_library(source: Path, name: str) -> tuple[Path, str]:
    """Compile `source` for sm_90a; returns (library path, compiler log).

    The log holds ptxas's register and shared-memory report; it is empty
    when the library was already built.
    """
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{source.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr
