"""Build the repo's C++ host runtime into a shared library with g++.

The g++ twin of `utils/cuda_build.py`: `native/robot_bridge.cpp` (the UDP
robot bridge and loop timer the JAX package loads from
`native/libqtpu_bridge.so`) is compiled with the JAX package's flags
(`-O2 -shared -fPIC -std=c++17 ... -lpthread`) into
`quadruped_tpu_torch/_build/` (listed in .gitignore), named by a hash of
the source and the flags. Each build writes a file of its own and moves it
into place with `os.replace`, so processes that build at once (test
workers) never load a half-written library. Nothing is written under
`native/`. A failed build raises with the compiler's log.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from quadruped_tpu_torch.utils.cuda_build import BUILD_DIR

ROOT = Path(__file__).resolve().parents[2]
BRIDGE_SOURCE = ROOT / "native" / "robot_bridge.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
GXX_LIBS = ("-lpthread",)


def gxx_path() -> str:
    """g++ from PATH; raises when there is none."""
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH: the host runtime "
                           "(native/robot_bridge.cpp) cannot be built")
    return found


def library_path(source: Path, name: str) -> Path:
    """Where `build_host_library(source, name)` puts its output."""
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(GXX_FLAGS + GXX_LIBS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build_host_library(source: Path = BRIDGE_SOURCE, name: str = "qtpu_bridge",
                       force: bool = False) -> tuple[Path, str, float]:
    """Compile `source` with g++ unless its library is there already (or
    `force`); returns (library path, compiler log, seconds). The log and
    seconds are empty and 0 when nothing was built."""
    import time

    out = library_path(source, name)
    if out.exists() and not force:
        return out, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [gxx_path(), *GXX_FLAGS, "-o", str(tmp), str(source), *GXX_LIBS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"{source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr, seconds
