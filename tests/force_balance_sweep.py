"""A sweep of the force-balance QP, port against the JAX package, on CPU.

    PYTHONPATH=. python tests/force_balance_sweep.py [--states 280]

Not a test: it measures what tests/test_torch_force_balance.py and
tests/test_torch_locomotion_modes.py hold, on more states than they run.
For `--states` random stance states (test_torch_force_balance's inputs and
patterns) it solves the force-balance QP in float32 with both packages and
in float64 with the port, as `compute_contact_forces` at
ForceBalanceConfig() (flat ground) and with track_xy, a tilted normal and a
warm start, and prints per variant: the states on which each float32 solve
misses the float64 minimizer by more than MISS_N, the largest
port-vs-JAX difference where both find it, and for each pair of the three
solves (`ref` is JAX) the median difference and the states within 0.05 N.
Then it counts the ticks of the
two closed loops of test_torch_locomotion_modes whose forces leave a
friction pyramid, per package. One JSON line per variant.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent))
import conftest  # noqa: E402,F401  (JAX on CPU, float32)
import test_torch_force_balance as fb  # noqa: E402
import test_torch_locomotion_modes as modes  # noqa: E402


def sweep(states: int) -> None:
    variants = {"default": dict(track_xy=False, warm=False, normal=None,
                                ramp=False),
                "track_xy_tilted_warm": dict(track_xy=True, warm=True,
                                             normal=fb.TILTED, ramp=False)}
    for name, kw in variants.items():
        held = {}

        def record(path, port, ref, f64):
            port, ref, f64 = (np.asarray(v, np.float64).reshape(len(v), -1)
                              for v in (port, ref, f64))
            held.update(port=port, ref=ref, f64=f64)

        saved, fb._hold_forces = fb._hold_forces, record
        try:
            fb._forces_case(states, 123, **kw)
        finally:
            fb._hold_forces = saved
        miss_port = np.abs(held["port"] - held["f64"]).max(-1) > fb.MISS_N
        miss_ref = np.abs(held["ref"] - held["f64"]).max(-1) > fb.MISS_N
        both = ~miss_port & ~miss_ref
        diff = np.abs(held["port"] - held["ref"]).max(-1)
        # Per pair: the median per-state max |diff| and the states within
        # 0.05 N, over all states.
        pairs = {}
        for a, b in (("port", "ref"), ("port", "f64"), ("ref", "f64")):
            d = np.abs(held[a] - held[b]).max(-1)
            pairs[f"{a}_vs_{b}"] = {"median_N": float(np.median(d)),
                                    "within_0.05N": int((d <= 0.05).sum())}
        print(json.dumps({
            "variant": name, "states": states,
            "misses_port": int(miss_port.sum()),
            "misses_jax": int(miss_ref.sum()),
            "misses_both": int((miss_port & miss_ref).sum()),
            "max_diff_N_where_both_find": float(diff[both].max()),
            "pairs": pairs}),
            flush=True)


def closed_loop() -> None:
    for name in modes.MODES:
        port = modes._missed(modes._port_run(name)["forces_trace"])
        ref = modes._missed(modes._jax_run(name)["forces_trace"])
        print(json.dumps({"closed_loop": name, "ticks": int(port.size),
                          "missed_ticks_port": int(port.sum()),
                          "missed_ticks_jax": int(ref.sum())}), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--states", type=int, default=280)
    sweep(ap.parse_args().states)
    closed_loop()
