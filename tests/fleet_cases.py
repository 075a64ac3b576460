"""Shared pieces of the fleet tests (tests/test_torch_fleet_*.py): the
robots, the batches at which a stacked field would broadcast wrongly, and
the comparison of a fleet's step with each scenario's step alone."""

import numpy as np
import torch

from quadruped_tpu_torch.utils.convert import as_numpy, flatten

# Every robot of the JAX package: the fleets cycle through them.
ROBOTS = ("a1", "go1", "aliengo", "lite3", "lite2")
# B = 3, 4, 5 and 12: where a [B] field meeting a [B, 3], [B, 4] or
# [B, 12] tensor would broadcast over axes, legs or joints without an
# error (5: none of them, 12: joints).
BATCHES = (3, 4, 5, 12)


def cycle(batch: int, names=ROBOTS) -> list:
    """The robot of each scenario: `names` in turn."""
    return [names[i % len(names)] for i in range(batch)]


def heights(names) -> np.ndarray:
    """Each robot's nominal body height less 1 cm, float32 (the fleet
    harness's command, benchmarks/fleet_paths.py)."""
    from quadruped_tpu_torch.benchmarks.fleet_paths import commanded_height
    from quadruped_tpu_torch.robots import stack_params

    return commanded_height(stack_params(names, "cpu")).numpy()


def flat(**parts) -> dict:
    """Dataclasses and tensors -> {path: numpy array}."""
    return flatten({k: as_numpy(v) for k, v in parts.items()}, "")


def assert_rows_equal(fleet: dict, alone: list, names):
    """Scenario i of `fleet` ({key: [B, ...]}) equals scenario i of
    `alone[i]` ({key: [B, ...]}, the same batch run with scenario i's
    one-robot parameters) to float32 rounding (`torch.testing.
    assert_close`'s float32 limits); integer and boolean leaves exactly."""
    for i, one in enumerate(alone):
        assert sorted(one) == sorted(fleet)
        for k, v in one.items():
            torch.testing.assert_close(
                torch.from_numpy(np.ascontiguousarray(fleet[k][i])),
                torch.from_numpy(np.ascontiguousarray(v[i])),
                msg=lambda m, k=k, i=i: f"scenario {i} ({names[i]}) {k}: "
                                        f"{m}")


def max_err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
