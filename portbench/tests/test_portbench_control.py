"""The control on the card: the plain reference in the nearest precision
below the configuration's (float32 products on the TF32 tensor cores), put
in the program's place, fails at least one of each cell's limits, while
the program passes them, at a size a test run holds. Marked `cuda`; it
skips without a card."""

import pytest
import torch

from portbench import calibrate, check, harness
from portbench.tests.cases import driver

CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]]
# The control's size for each driver, so a cell added by files alone has one.
SIZES = {
    "sweep": dict(batch=256),
    "update": dict(batch=1024),
    "tick": dict(),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 products run on "
                    "the tensor cores")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    limits = check.limits(name)
    assert limits, f"no limits for {name}"
    r = calibrate.readings(name, 2 ** 31 + 101, 2.0, True, card,
                           overrides=SIZES[driver(name)])
    ok, _ = check.verdict(r["program"], limits)
    assert ok, r["program"]
    control_ok, _ = check.verdict(r["control"], limits)
    assert not control_ok, r["control"]
    assert harness.forbidden_modules() == []
