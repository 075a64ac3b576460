"""CPU checks of the benchmark harness: the cells resolve to their files,
every driver's rehearsal gives the result line's keys, the roofline count,
the import rules, the refusal without a card, and cells added by files
alone."""

import ast
import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

import pytest
import torch

from portbench import harness, roofline
from portbench.tests import cases

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    files = harness.cell_files(name)
    cell = files["cell"]
    assert files["config"]["name"] == cell["config"]
    assert (PACKAGE / "limits" / f"{name}.json").exists()
    ref = files["traffic"].get("reference")
    if ref:
        assert (PACKAGE / "reference" / f"{ref}.py").exists()
    for fn in ("setup", "window", "end_to_end", "work", "lines", "check"):
        assert callable(getattr(files["driver"], fn)), fn
    assert set(cases.small(name)) <= set(files["traffic"])
    for m in files["per_layer"]:
        assert callable(harness.reader(m["name"]))
    reported = {m["name"] for m in files["end_to_end"]}
    for m in BENCH["per_layer"]:
        if name in m.get("workloads", []):
            assert m["moves"] in reported, m["name"]
    assert "setup_s" in reported
    assert len(files["end_to_end"]) >= 2 and files["per_layer"]
    entry = {c["name"]: c for c in BENCH["configs"]}[cell["config"]]
    assert (ROOT / entry["file"]).exists()
    assert entry["reduced"] == files["config"]["reduced"]


@pytest.mark.parametrize("name", CELLS)
def test_config_numbers_are_the_programs(name):
    """The configuration file's robot and gait are the port's named ones,
    so the program and the reference run the same robot."""
    from portbench import program
    from portbench.reference import params, scheduler
    config = harness.cell_files(name)["config"]
    _, prog = program.locomotion(config, "cpu")
    ref = params.from_config(config["robot"], "cpu")
    for field in ref.__dataclass_fields__:
        assert torch.equal(getattr(prog, field), getattr(ref, field)), field
    from quadruped_tpu_torch.gait.scheduler import named_gait
    g_prog = named_gait(config["gait"]["name"], "cpu")
    g_ref = scheduler.from_config(config["gait"], "cpu")
    for field in g_ref.__dataclass_fields__:
        assert torch.equal(getattr(g_prog, field), getattr(g_ref, field))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_gives_the_result_keys(name, trace):
    r = harness.rehearse(name, seed=2 ** 31 + 11, seconds=0.3, trace=trace,
                         overrides=cases.small(name))
    for key in KEYS:
        assert key in r
    assert list(r)[-1] == "checks"
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    if not trace:
        names = {m["name"] for m in harness.cell_files(name)["end_to_end"]}
        assert set(r["metrics"]) == names
        assert all(v["value"] > 0 for v in r["metrics"].values())
    else:
        assert r["device"]["window_s"] > 0
        assert "breakdown" in r


def test_roofline_matches_a_hand_count():
    # K1 at B=8192, n=120 (T=40, m=200), 24 iterations: M^{-1} 14400,
    # q 120, mu 1, lo/hi/rho 600, x0 120, y0 200, x 120, y 200 floats.
    nbytes, ops = roofline.admm_work(8192, 120, 24)
    assert nbytes == 4 * 8192 * (14400 + 120 + 1 + 600 + 120 + 200 + 120
                                 + 200)
    assert ops == {"f32": 8192 * 24 * (2 * 14400 + 16 * 200 + 4 * 120)}
    seconds, by = roofline.bound_s(nbytes, ops)
    assert by == "bytes"
    assert seconds == pytest.approx(516456448 / 3.35e12)


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_port():
    for path in (PACKAGE / "reference").glob("*.py"):
        assert not _imports(path) & {"quadruped_tpu_torch", "quadruped_tpu",
                                     "jax", "jaxlib", "flax"}, path
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, pkgutil, importlib, portbench.reference as r\n"
         "for m in pkgutil.iter_modules(r.__path__):\n"
         "    importlib.import_module('portbench.reference.' + m.name)\n"
         "print(sorted({k.split('.')[0] for k in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, check=True).stdout
    top = set(eval(out))
    assert not top & {"quadruped_tpu_torch", "quadruped_tpu", "jax",
                      "jaxlib", "flax"}


def test_harness_loads_no_jax():
    """Whole top-level names: the port's name begins with the JAX
    package's."""
    code = ("import sys\n"
            "from portbench import harness\n"
            "from portbench.tests.cases import small\n"
            f"for n in {CELLS!r}:\n"
            "    harness.rehearse(n, 3, 0.2, True, small(n))\n"
            "print(sorted({k.split('.')[0] for k in sys.modules}))\n"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    top, found = out.stdout.strip().splitlines()[-2:]
    assert "quadruped_tpu_torch" in eval(top)
    assert eval(found) == []
    for path in PACKAGE.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax",
                                     "quadruped_tpu"}, path


def test_measurement_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_files_added_to_a_copy_are_found(tmp_path):
    """A configuration, a traffic mix, a cell and its limits added as new
    files and BENCHMARK.json entries run with no edit of any file, and
    pass the benchmark's own parametrised tests in the copy."""
    shutil.copytree(PACKAGE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((PACKAGE / "configs" / "a1-trot-mpc-h10.json")
                     .read_text())
    cfg["name"] = "a1-trot-mpc-h10-copy"
    (tmp_path / "portbench" / "configs" / "a1-trot-mpc-h10-copy.json") \
        .write_text(json.dumps(cfg))
    sweep = next(w for w in BENCH["workloads"]
                 if cases.driver(w["name"]) == "sweep")
    traffic = json.loads((PACKAGE / "traffic" / f"{sweep['traffic']}.json")
                         .read_text())
    traffic.update(cases.BY_DRIVER["sweep"], batch=3)
    (tmp_path / "portbench" / "traffic" / "sweep-b3.json").write_text(
        json.dumps(traffic))
    shutil.copy(PACKAGE / "limits" / f"{sweep['name']}.json",
                tmp_path / "portbench" / "limits" / "copy.sweep-b3.json")
    bench["configs"].append(dict(bench["configs"][0],
                                 name="a1-trot-mpc-h10-copy",
                                 file="portbench/configs/"
                                      "a1-trot-mpc-h10-copy.json"))
    bench["workloads"].append({"name": "copy.sweep-b3",
                               "config": "a1-trot-mpc-h10-copy",
                               "traffic": "sweep-b3", "chips": 1,
                               "why": "a cell made of new files"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if sweep["name"] in m.get("workloads", []):
            m["workloads"].append("copy.sweep-b3")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json\nfrom portbench import harness\n"
            "print(json.dumps(harness.rehearse('copy.sweep-b3', 5, 0.2)))")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True, check=True)
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert set(r["metrics"]) == {"robot_s_per_s", "setup_s"}
    assert r["attempted"] % 3 == 0
    # The benchmark's own tests, run in the copy, take the new cell as one
    # more case each (its name's "." and "-" cannot be in a -k expression).
    xml = tmp_path / "copy.xml"
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "portbench/tests", "-q",
         "-p", "no:cacheprovider", "-k", "copy and not files_added",
         f"--junitxml={xml}"],
        cwd=tmp_path, env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout[-4000:]
    control = "passed" if torch.cuda.is_available() else "skipped"
    cases_run = {}
    for case in ET.parse(xml).iter("testcase"):
        assert "copy.sweep-b3" in case.get("name"), case.get("name")
        test = case.get("name").split("[")[0]
        outcome = "skipped" if case.find("skipped") is not None else "passed"
        cases_run.setdefault(test, []).append(outcome)
    assert cases_run == {
        "test_cell_resolves_to_its_files": ["passed"],
        "test_config_numbers_are_the_programs": ["passed"],
        "test_rehearsal_gives_the_result_keys": ["passed"] * 2,
        "test_closed_loop_fault_is_caught": ["passed"] * 3,
        "test_rehearsal_reads_the_spans_of_its_cell": ["passed"],
        "test_control_fails_and_program_passes": [control],
    }


def test_a_directory_of_the_benchmark_alone_refuses(tmp_path):
    """Only BENCHMARK.json and the files under `paths`: no program, no
    result line."""
    shutil.copytree(PACKAGE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_carry_maps_hand_over_a_state_laid_out_anew(tmp_path, monkeypatch):
    """The reference takes the program's state through the carry maps: the
    port's own layout by the same paths, and a layout that renames, packs
    or drops fields through a map file added beside it, with no edit."""
    import dataclasses
    from portbench import tree

    @dataclasses.dataclass
    class Mpc:
        forces: torch.Tensor
        warm: torch.Tensor

    @dataclasses.dataclass
    class Carry:
        mpc: Mpc
        cache: torch.Tensor
        step: int

    ref = Carry(Mpc(torch.zeros(2, 4, 3), torch.zeros(2, 6)),
                torch.zeros(2), 0)
    same = Carry(Mpc(torch.ones(2, 4, 3), torch.arange(12.).reshape(2, 6)),
                 torch.ones(2), 7)
    loaded, name = tree.load(ref, same)
    assert name == "rollout"
    assert torch.equal(loaded.mpc.warm, same.mpc.warm) and loaded.step == 7

    packed = {"mpc": {"packed": torch.cat([same.mpc.forces.reshape(2, 12),
                                           same.mpc.warm], 1)},
              "step": 7}
    with pytest.raises(KeyError):
        tree.load(ref, packed)
    maps = tmp_path / "carry"
    shutil.copytree(tree.MAPS, maps)
    (maps / "rollout-packed.json").write_text(json.dumps({
        "why": "forces and warm start packed in one field; no cache",
        "fields": {"mpc.forces": {"path": "mpc.packed", "last_axis": [0, 12]},
                   "mpc.warm": {"path": "mpc.packed", "last_axis": [12, 18]},
                   "cache": None}}))
    monkeypatch.setattr(tree, "MAPS", maps)
    loaded, name = tree.load(ref, packed)
    assert name == "rollout-packed"
    assert torch.equal(loaded.mpc.forces, same.mpc.forces)
    assert torch.equal(loaded.mpc.warm, same.mpc.warm)
    assert torch.equal(loaded.cache, ref.cache) and loaded.step == 7


def test_idle_gaps_are_named_by_the_work_that_ends_them():
    """Every gap of the window is named by the device operation that ended
    it, or is the gap after the last work; together they are the idle
    time. Times are on the profiler's epoch clock, as the trace gives them."""
    import numpy as np
    from portbench.trace import Trace
    t0 = 1.76e9
    device = [(t0 + 1e-3 * i, t0 + 1e-3 * i + 4e-4, f"k{i % 3}")
              for i in range(1000)] + [(t0 - 1.0, t0 + 2e-4, "early")]
    tr = Trace(window=(t0, t0 + 1.2), units=1, unit_spans=np.zeros((1, 2)),
               device=device, launches=np.zeros(0))
    gaps = dict(tr.idle_gaps())
    assert set(gaps) == {"before k0", "before k1", "before k2",
                         "after the last device work"}
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s())
