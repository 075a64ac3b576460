"""One run of one cell: set-up, the measured window, the metrics, the check
and the result line. `run.py` calls `run` on the card; the tests call
`rehearse`, the same path on the CPU at a size the traffic overrides give,
which is never a fallback of the command."""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from portbench import check
from portbench.trace import Tracer

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
# Top-level module names that no run may hold once its window has closed:
# JAX and the JAX package, compared whole (the port's name begins with the
# JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "quadruped_tpu")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_files(name: str) -> dict:
    """The cell `name` of BENCHMARK.json with its configuration, traffic,
    driver module and end-to-end and per-layer metric entries."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = load_json(PACKAGE / "configs" / f"{cell['config']}.json")
    traffic = load_json(PACKAGE / "traffic" / f"{cell['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])
                 and m["moves"] in moved]
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": e2e, "per_layer": per_layer,
            "driver": importlib.import_module(
                f"portbench.drivers.{traffic['driver']}")}


def reader(metric: str):
    """The reader of a per-layer metric: metrics/<name>.py, else
    metrics/<name up to its first dot>.py."""
    for stem in (metric, metric.split(".")[0]):
        path = PACKAGE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"portbench.metrics.{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for per-layer metric {metric!r}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def card_line(device: torch.device) -> str:
    """The card's name and power limit, which bounds its clocks under load:
    every time and roofline share is read beside it."""
    if device.type != "cuda":
        return "card: none (CPU)"
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i",
                              str(device.index or 0)], capture_output=True,
                             text=True, timeout=30, check=True).stdout
        return f"card: {out.strip()}"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"card: {torch.cuda.get_device_name(device)}, power limit " \
               f"not read ({exc})"


def _trace_cost(tracer: Tracer, win: dict) -> str:
    """The traced units' wall time a unit against the untraced rest of the
    window's (the profiler's stop left out): how far the profiler slows what
    it traces, and so how far the traced window's idle share reads high."""
    rest = win["units"] - tracer.done
    traced = 1e3 * tracer.wall_s / tracer.done
    if rest <= 0:
        return f"trace cost: {traced} ms a unit traced; no untraced unit"
    untraced = 1e3 * (win["elapsed_s"] - tracer.wall_s - tracer.stop_s) / rest
    return (f"trace cost: {traced} ms a unit traced, {untraced} ms "
            f"untraced ({100 * (traced / untraced - 1)}%)")


def run(name: str, seed: int, seconds: float, trace: bool, device,
        t0: float, overrides: dict | None = None) -> tuple[dict, list]:
    """(result, lines for standard error) of one run; `t0` is the process
    start on the perf_counter clock."""
    files = cell_files(name)
    traffic = dict(files["traffic"], **(overrides or {}))
    driver = files["driver"]
    t_setup = time.perf_counter()
    state = driver.setup(files["config"], traffic, seed, device)
    setup_s = time.perf_counter() - t0
    tracer = Tracer(trace, traffic["trace_units"], device)
    win = driver.window(state, seconds, tracer)
    tracer.close()
    dev = _device_info(device, files["cell"]["chips"])
    lines = [card_line(device)] + driver.lines(state, win)
    metrics = {}
    if trace:
        tr, work = tracer.trace, driver.work(state, win)
        for m in files["per_layer"]:
            value = reader(m["name"])(tr, work)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tr is not None:
            dev["busy_s"] = tr.busy_s()
            dev["window_s"] = tr.window_s
            breakdown = {"device_ops": tr.device_ops(),
                         "idle_gaps": tr.idle_gaps()}
            lines.append(f"traced {tr.units} units: busy {dev['busy_s']} s "
                         f"of {dev['window_s']} s")
            lines.append(_trace_cost(tracer, win))
    else:
        values = dict(driver.end_to_end(state, win), setup_s=setup_s)
        for m in files["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    numbers = driver.check(state)["program"]
    if "carry_map" in state:
        lines.append(f"carry map: reference/carry/{state['carry_map']}.json")
    correct, checks = check.verdict(numbers, check.limits(name))
    result = {"correct": correct, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": dev}
    if trace and tracer.trace is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    lines.append(f"setup_s {setup_s}: imports {t_setup - t0} s, then "
                 f"{setup_s - t_setup + t0} s of CUDA init, K1's build or "
                 f"load, the boot solve and the warm-up")
    lines += [f"check {k}: {c['value']} (limit {c['limit']})"
              for k, c in checks.items()]
    return result, lines


def rehearse(name: str, seed: int = 1, seconds: float = 0.5,
             trace: bool = False, overrides: dict | None = None) -> dict:
    """The run's whole path on the CPU, at the size `overrides` sets in the
    traffic (a rehearsal for the tests; the command itself needs a card)."""
    result, _ = run(name, seed, seconds, trace, torch.device("cpu"),
                    time.perf_counter(), overrides)
    return result
