"""Runs one cell of ``BENCHMARK.json`` and builds its result line.

Everything is found by name, so a later cell, configuration, traffic mix,
driver or metric is a new file and a new entry, never an edit:

* the cell (``workloads``) names a configuration and a traffic mix;
* the configuration's ``file`` (``configs/<config>.json``) names its
  driver (``drivers/<driver>.py``, a module with ``run(Run) -> Outcome``);
* the traffic mix is ``traffic/<traffic>.json``, parameters the driver
  reads;
* every metric is ``metrics/<metric>.py``, a module with ``UNIT`` and
  ``read(obs) -> float | None``. A cell reports the ``end_to_end`` metrics
  (``--trace 0``) or the ``per_layer`` metrics (``--trace 1``) whose
  ``workloads`` list it, or that have no such list. A reader that finds
  nothing to read returns None and its metric is left out.

``obs`` is the driver's dictionary of observations: the host clock's
readings, the engines' phase timers and the reduced device trace (see the
drivers for the keys each fills).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# Top-level module names that may not be loaded in a run: JAX, its
# relatives and the JAX package the port was made from. Compared whole,
# so ``josefine_tpu_torch`` is not one of them.
FORBIDDEN = ("jax", "jaxlib", "flax", "josefine_tpu")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


@dataclasses.dataclass
class Run:
    """One run of one cell, as the driver gets it."""

    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object          # torch.device the program runs on
    t0: float               # time.perf_counter() at process start
    control: bool = False   # run the configuration's control (see PERF.md)
    fault: object = None    # tests: callable(system) applied as the window opens


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: observations for the metric readers, the
    request counts, every number compared with its limit, the program's
    memory peak and, in a traced run, the reduced device trace."""

    obs: dict
    attempted: int
    failed: int
    checks: dict            # name -> (value, limit); correct iff value <= limit
    memory_peak_bytes: int
    traced: dict | None = None


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _named(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_config(spec: dict, cell: dict, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == cell["config"]:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {cell['config']!r} in BENCHMARK.json")


def load_traffic(name: str, root: Path = ROOT) -> dict:
    with open(root / "benchmark" / "traffic" / f"{_named(name)}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = ROOT):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / "benchmark" / kind / f"{_named(name)}.py"
    mod_name = f"benchmark_{kind}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced."""
    group = spec["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metrics(spec: dict, cell: str, trace: bool, obs: dict,
                 root: Path = ROOT) -> dict:
    out = {}
    for m in cell_metrics(spec, cell, trace):
        v = load_module("metrics", m["name"], root).read(obs)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is in :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def execute(workload: str, seed: int, seconds: float, trace: bool, device, t0: float,
            root: Path = ROOT, control: bool = False, fault=None) -> tuple[dict, Outcome]:
    """Run the cell once through its driver; the result line and the
    driver's outcome."""
    spec = load_spec(root)
    cell = find_cell(spec, workload)
    cfg = load_config(spec, cell, root)
    run = Run(config=cfg, traffic=load_traffic(cell["traffic"], root),
              seed=seed, seconds=seconds, trace=trace, device=device, t0=t0,
              control=control, fault=fault)
    out = load_module("drivers", cfg["driver"], root).run(run)
    obs = dict(out.obs, device_kind=_device_kind(device), devices_used=_devices_used(device))
    if out.traced is not None:
        obs["device_trace"] = out.traced
    return result_line(spec, cell, trace, obs, out, device, root), out


def _device_kind(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _devices_used(device) -> int:
    """The cards the run allocated memory on, as counted after the run."""
    import torch

    if device.type != "cuda":
        return 1
    return sum(torch.cuda.max_memory_allocated(d) > 0 for d in range(torch.cuda.device_count()))


def result_line(spec: dict, cell: dict, trace: bool, obs: dict, out: Outcome, device,
                root: Path = ROOT) -> dict:
    correct = all(v <= lim for v, lim in out.checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": obs["device_kind"], "count": obs["devices_used"],
           "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": correct, "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": read_metrics(spec, cell["name"], trace, obs, root), "device": dev}
    if trace and out.traced is not None:
        dev["busy_s"] = out.traced["busy_s"]
        dev["window_s"] = out.traced["window_s"]
        line["breakdown"] = {"device_ops": out.traced["device_ops"],
                             "idle_gaps": out.traced["idle_gaps"]}
    # Last key: every number compared, beside its limit.
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return line


def main(workload: str, seed: int, seconds: float, trace: bool, t0: float) -> int:
    """The command line's run: on the card only; prints the result line
    last on stdout and the compared numbers last on stderr."""
    spec = load_spec()
    cell = find_cell(spec, workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # One host thread for PyTorch's own CPU work: the load comes from one
    # process, and a steadier host gives steadier runs.
    torch.set_num_threads(1)
    line, out = execute(workload, seed, seconds, trace, torch.device("cuda", 0), t0)
    for k, v in out.obs.get("diagnostics", {}).items():
        print(f"diagnostic {k} {v}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
