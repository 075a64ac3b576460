"""The port on one NVIDIA GPU: every card case of its tests, then each kernel
alone, and one `kernels` line of what that run measured.

    PYTHONPATH=$PWD python3 chip_smoke.py

Runs the card command (tests/card_device.py) in this process: each module
tests/test_torch_*.py that imports card_device or carries the `cuda` mark,
its `cuda` cases over four xdist workers, without tests/conftest.py (it
imports JAX, which the card's machine lacks). Then
`quadruped_tpu_torch.benchmarks.kernels`, one JSON line a reading. Last,
the `kernels` line: each kernel's ms, plain_ms and bound_ms at each shape
of that run, and the launches of each kernel the card's tests counted
(`card_device.launch_record`), in all and by test. The limits are the
tests'; the exit code is pytest's.
"""

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent
CARD = re.compile(r"card_device|mark\.cuda")


def card_modules() -> list:
    return sorted(str(p.relative_to(ROOT))
                  for p in (ROOT / "tests").glob("test_torch_*.py")
                  if CARD.search(p.read_text()))


class Launches:
    """Each test's "launches" user property, as its report reaches the
    controller."""

    def __init__(self):
        self.by_test = {}

    def pytest_runtest_logreport(self, report):
        for key, value in report.user_properties:
            if key == "launches":
                self.by_test[report.nodeid] = value


def main() -> int:
    launches = Launches()
    rc = pytest.main(["--noconftest", "-p", "no:cacheprovider", "-p", "xdist",
                      "-n", "4", "--dist", "loadfile", "-m",
                      "cuda and not slow", "--rootdir", str(ROOT),
                      *card_modules()], plugins=[launches])
    from quadruped_tpu_torch.benchmarks import kernels

    rows = []
    for row in kernels.readings():
        print(json.dumps(row), flush=True)
        rows.append(row)
    total = {}
    for got in launches.by_test.values():
        for kernel, n in got.items():
            total[kernel] = total.get(kernel, 0) + n
    print("kernels " + json.dumps({
        "card": rows[0]["card"], "pytest_rc": int(rc),
        "kernels": [{k: r[k] for k in ("kernel", "shape", "ms", "plain_ms",
                                       "bound_ms")} for r in rows[1:]],
        "launches": total, "launches_by_test": launches.by_test}),
        flush=True)
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
