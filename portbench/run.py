"""Run one cell of BENCHMARK.json on the card and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout. Exits non-zero, printing no result, without
a CUDA card (or with fewer than the cell asks for), or when JAX or the JAX
package is loaded once the window has closed. The last line of standard
output is the result; the numbers compared for `correct` are the last lines
of standard error and the result's last key.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def _environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port builds its kernels into quadruped_tpu_torch/_build/ itself), and
    one host thread for torch's CPU work: the card's host is shared, and
    the run's host work is one Python thread launching kernels."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    _environment()
    import torch
    torch.set_num_threads(1)

    from portbench import harness
    chips = harness.cell_files(a.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: cell {a.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    result, lines = harness.run(a.workload, a.seed, a.seconds,
                                bool(a.trace), device, T0)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules loaded that no run may hold: {found}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
