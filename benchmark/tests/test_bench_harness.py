"""The harness: discovery by name, the result line, the card check and the
import check."""

import ast
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness

from .conftest import ROOT

CELL = "raft100k5.omb_topic100"
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]

TOY_DRIVER = '''
"""A driver added as a file of its own."""
from benchmark.harness import Outcome


def run(run):
    n = run.traffic["requests"] * run.config["scale"]
    return Outcome(obs={"setup_s": 0.5, "served": n, "window_s": run.seconds},
                   attempted=n, failed=0, checks={"wrong": (0, 0)}, memory_peak_bytes=0,
                   traced={"busy_s": 0.1, "window_s": 1.0, "device_ops": [["k", 0.1]],
                           "idle_gaps": [["host", 0.9]]} if run.trace else None)
'''
TOY_METRIC = '''
"""A metric added as a file of its own."""
UNIT = "ops/s"
LAYER = "toy"
MOVES = "served_per_s"


def read(obs):
    return obs["served"] / obs["window_s"] if "served" in obs else None
'''


def _add_cell(root):
    """A configuration, traffic mix, driver, metric and cell added as new
    files and new entries only."""
    (root / "benchmark" / "drivers" / "toy_driver.py").write_text(TOY_DRIVER)
    (root / "benchmark" / "metrics" / "served_per_s.py").write_text(TOY_METRIC)
    (root / "benchmark" / "metrics" / "toy.served_ms.py").write_text(
        TOY_METRIC.replace('"ops/s"', '"ms"'))
    (root / "benchmark" / "configs" / "toy-a.json").write_text(
        json.dumps({"name": "toy-a", "driver": "toy_driver", "scale": 3, "reduced": []}))
    (root / "benchmark" / "traffic" / "toy_mix.json").write_text(json.dumps({"requests": 7}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy-a", "source": "https://example.org/toy",
                            "file": "benchmark/configs/toy-a.json", "reduced": [],
                            "why": "toy"})
    spec["workloads"].append({"name": "toy-a.mix", "config": "toy-a", "traffic": "toy_mix",
                              "chips": 1, "why": "toy"})
    spec["end_to_end"].append({"name": "served_per_s", "unit": "ops/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["toy-a.mix"]})
    spec["per_layer"].append({"name": "toy.served_ms", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "toy", "moves": "served_per_s",
                              "workloads": ["toy-a.mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.mark.parametrize("trace", [False, True])
def test_a_cell_added_as_files_only_runs(tmp_path, trace):
    from .conftest import copy_benchmark

    root = copy_benchmark(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    _add_cell(root)
    assert all(p.read_bytes() == b for p, b in before.items())  # nothing edited
    line, _ = harness.execute("toy-a.mix", 1, 2.0, trace, torch.device("cpu"),
                              time.perf_counter(), root=root)
    keys = CONTRACT_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == keys
    assert line["correct"] and line["attempted"] == 21
    assert line["checks"] == {"wrong": {"value": 0, "limit": 0}}
    if trace:
        assert line["metrics"] == {"toy.served_ms": {"value": 10.5, "unit": "ms"}}
        assert line["device"]["busy_s"] == 0.1 and line["device"]["window_s"] == 1.0
    else:
        assert line["metrics"] == {"served_per_s": {"value": 10.5, "unit": "ops/s"},
                                   "setup_s": {"value": 0.5, "unit": "s"}}
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


def test_result_line_of_a_toy_cell_run(toy_root):
    line, _ = harness.execute(CELL, 2 ** 31 + 12345, 1.0, False,
                              torch.device("cpu"), time.perf_counter(), root=toy_root)
    assert list(line) == CONTRACT_KEYS + ["checks"]
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"commits_per_s", "commit_p99_ms", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["count"] == 1


def test_the_rate_counts_only_answers_inside_the_window(toy_root):
    """A long warm-up and a window of one round: what the warm-up had
    answered before the window opened is not the window's work."""
    path = toy_root / "benchmark" / "traffic" / "omb_topic100_1kb.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), warmup_rounds=30)))
    _, out = harness.execute(CELL, 31415926535, 1e-9, False, torch.device("cpu"),
                             time.perf_counter(), root=toy_root)
    obs = out.obs
    assert obs["rounds"] == 1 and obs["window_proposals"] == 16
    assert 0 < obs["acked"] <= obs["window_proposals"] + obs["in_flight_at_start"]


def test_without_a_card_the_command_fails_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELL,
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""


def test_without_the_program_the_command_fails(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's files."""
    from .conftest import copy_benchmark

    root = copy_benchmark(tmp_path)
    code = ("import sys, time; sys.path.insert(0, '.'); import torch; "
            "from benchmark import harness; "
            f"harness.execute({CELL!r}, 1, 1.0, False, torch.device('cpu'), "
            "time.perf_counter(), root=__import__('pathlib').Path('.'))")
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and "josefine_tpu_torch" in r.stderr


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.core", "josefine_tpu",
            "josefine_tpu.models", "josefine_tpu_torch", "josefine_tpu_torch.raft",
            "jaxtyping", "flaxen", "numpy"]
    assert harness.forbidden_modules(mods) == ["flax.core", "jax", "jax.numpy",
                                               "jaxlib.xla_client", "josefine_tpu",
                                               "josefine_tpu.models"]


def test_a_toy_run_loads_no_jax_and_no_jax_package(toy_root):
    """After a whole run, in a process of its own, every module's
    top-level name is checked whole against JAX and the JAX package."""
    code = (f"import sys, time; sys.path.insert(0, {str(ROOT)!r}); import torch; "
            "from pathlib import Path; from benchmark import harness; "
            f"line, _ = harness.execute({CELL!r}, 7, 1.0, True, torch.device('cpu'), "
            f"time.perf_counter(), root=Path({str(toy_root)!r})); "
            "assert line['correct'], line['checks']; "
            "print(sorted({m.split('.')[0] for m in sys.modules})); "
            "print(harness.forbidden_modules())")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    top, bad = r.stdout.strip().splitlines()[-2:]
    assert "josefine_tpu_torch" in top and bad == "[]"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_the_references_import_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"josefine_tpu_torch", "josefine_tpu", "jax", "torch"}, path
    code = ("import sys; sys.path.insert(0, '.'); "
            "import benchmark.reference.replicated_log; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('josefine_tpu_torch', 'josefine_tpu', 'jax', 'torch')))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "[]", r.stderr


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in (ROOT / "benchmark").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path


@pytest.mark.gpu
def test_cell_on_the_card(card):
    """One short run of each cell through the command, on the card."""
    for cell in (w["name"] for w in harness.load_spec()["workloads"]):
        r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                            "--seed", "2718281828", "--seconds", "3", "--trace", "0"],
                           cwd=ROOT, capture_output=True, text=True, timeout=1200)
        assert r.returncode == 0, r.stderr[-3000:]
        line = json.loads(r.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["device"]["platform"] == "gpu", line["checks"]
