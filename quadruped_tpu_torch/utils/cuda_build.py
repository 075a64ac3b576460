"""Build CUDA sources of this package into plain-C shared libraries with nvcc.

A library goes to `quadruped_tpu_torch/_build/` (listed in .gitignore),
named by a hash of its source, the headers beside it and the flags, so a
changed source or header builds anew and an unchanged one is built once per
checkout. Nothing here runs at import time; the kernel wrappers call
`build_shared_library` at their first launch, and `build_shared_libraries`
starts one nvcc per source at once.
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


def _library_path(source: Path, name: str) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build_shared_libraries(
        specs: list[tuple[Path, str]]) -> list[tuple[Path, str]]:
    """Compile each (source, name) for sm_90a, all nvcc processes at once;
    returns [(library path, compiler log)] in the order given.

    A log holds ptxas's register and shared-memory report; it is empty when
    the library was already built.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source, name in specs:
        out = _library_path(source, name)
        if out.exists():
            jobs.append((source, out, None, None))
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((source, out, tmp, proc))
    results, failed = [], []
    for source, out, tmp, proc in jobs:
        if proc is None:
            results.append((out, ""))
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building "
                          f"{source.name}:\n{log}")
            continue
        os.replace(tmp, out)
        results.append((out, log))
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def build_shared_library(source: Path, name: str) -> tuple[Path, str]:
    """Compile one source; see `build_shared_libraries`."""
    return build_shared_libraries([(source, name)])[0]
