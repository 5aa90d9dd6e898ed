"""The PyTorch port stands alone: importing it (every submodule, and
``chip_smoke.py``) loads neither JAX, flax nor the JAX package, and builds
nothing; its entry points allocate on the card unless told otherwise, and a
mesh asked for on the card never falls back to the host."""

import inspect
import json
import os
import subprocess
import sys

import pytest
import torch

from josefine_tpu_torch import (
    bench,
    bench_engine,
    bench_node,
    bench_podsim,
    bench_server,
    interop,
)
from josefine_tpu_torch.chaos.harness import ChaosCluster, MembershipChaosCluster
from josefine_tpu_torch.chaos.search import ChaosSearch, Corpus
from josefine_tpu_torch.chaos.soak import run_soak, run_soak_async
from josefine_tpu_torch.chaos.wire_soak import WireCluster, run_wire_soak, run_wire_soak_async
from josefine_tpu_torch.config import EngineConfig, RaftConfig
from josefine_tpu_torch.models import chained_raft as cr, types
from josefine_tpu_torch.ops import _build
from josefine_tpu_torch.raft.engine import RaftEngine
from josefine_tpu_torch.raft.server import JosefineRaft
from josefine_tpu_torch.utils.kv import MemKV
from josefine_tpu_torch.workload.driver import TrafficEngine
from josefine_tpu_torch.workload.model import WorkloadSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, json, os, pkgutil, sys
import josefine_tpu_torch
names = [m.name for m in pkgutil.walk_packages(josefine_tpu_torch.__path__,
                                               "josefine_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "josefine_tpu"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_no_jax():
    before = os.listdir(_build.BUILD_DIR) if os.path.isdir(_build.BUILD_DIR) else []
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == [], f"the port loaded {out['bad']}"
    for name in ("josefine_tpu_torch.interop", "josefine_tpu_torch.bench",
                 "josefine_tpu_torch.ops.fused_step", "josefine_tpu_torch.ops._build",
                 "josefine_tpu_torch.models.chained_raft", "josefine_tpu_torch.models.py_step",
                 "josefine_tpu_torch.raft.engine", "josefine_tpu_torch.raft.packed_step",
                 "josefine_tpu_torch.raft.route", "josefine_tpu_torch.raft.payload_ring",
                 "josefine_tpu_torch.raft.lease", "josefine_tpu_torch.bench_engine",
                 "josefine_tpu_torch.bench_server", "josefine_tpu_torch.config",
                 "josefine_tpu_torch.bench_node", "josefine_tpu_torch.node_lockstep",
                 "josefine_tpu_torch.native", "josefine_tpu_torch.kafka",
                 "josefine_tpu_torch.kafka.codec", "josefine_tpu_torch.kafka.client",
                 *(f"josefine_tpu_torch.raft.{m}" for m in (
                     "server", "tcp", "pacer", "client", "lockstep")),
                 *(f"josefine_tpu_torch.utils.{m}" for m in (
                     "tracing", "kv", "metrics", "profiling", "flight", "spans", "health",
                     "shutdown", "net")),
                 "josefine_tpu_torch.broker", "josefine_tpu_torch.node",
                 "josefine_tpu_torch.__main__",
                 *(f"josefine_tpu_torch.broker.{m}" for m in (
                     "state", "fsm", "records", "log", "fetch_frame", "replica",
                     "partition_fsm", "groups", "handlers", "server")),
                 "josefine_tpu_torch.utils.coverage", "josefine_tpu_torch.chaos",
                 *(f"josefine_tpu_torch.chaos.{m}" for m in (
                     "faults", "invariants", "nemesis", "harness", "soak", "wire",
                     "wire_soak", "search")),
                 "josefine_tpu_torch.workload",
                 *(f"josefine_tpu_torch.workload.{m}" for m in (
                     "model", "schedule", "trace", "genome", "chaos_traffic", "driver",
                     "wire")),
                 "josefine_tpu_torch.parallel", "josefine_tpu_torch.parallel.sharded",
                 "josefine_tpu_torch.bench_podsim"):
        assert name in out["imported"]
    after = os.listdir(_build.BUILD_DIR) if os.path.isdir(_build.BUILD_DIR) else []
    assert after == before, "importing the port must build nothing"


@pytest.mark.parametrize("fn", [types.step_params, types.empty_msgs, cr.init_state,
                                cr.empty_inbox, bench.run, interop.state_from_numpy,
                                interop.msgs_from_numpy, interop.params_from_numpy,
                                interop.member_from_numpy, interop.peer_fresh_from_numpy,
                                RaftEngine.__init__, bench_engine.run,
                                JosefineRaft.__init__, bench_server.run, bench_node.run,
                                ChaosCluster.__init__, MembershipChaosCluster.__init__,
                                run_soak_async, WireCluster.__init__, run_wire_soak_async,
                                ChaosSearch.__init__, TrafficEngine.__init__,
                                bench_podsim.bench_row, bench_podsim.bench_engine_row,
                                bench_podsim.mesh_devices])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_config_defaults_to_the_card():
    assert (EngineConfig().backend, EngineConfig().device) == ("torch", "cuda")


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        assert types.step_params().timeout_min.device.type == "cuda"
        return
    for call in (types.step_params, lambda: cr.init_state(2, 3),
                 lambda: cr.empty_inbox(2, 3), bench.run,
                 lambda: interop.member_from_numpy([[True, False]]),
                 lambda: RaftEngine(MemKV(), [1, 2, 3], 1, groups=4),
                 lambda: bench_engine.run(4, ticks=1, warmup=1),
                 lambda: JosefineRaft(RaftConfig(), MemKV(), {}, groups=4),
                 lambda: bench_server.run(4, rounds=1, warmup=1),
                 lambda: bench_node.run(4, batches=2, traced=1),
                lambda: ChaosCluster(7), lambda: MembershipChaosCluster(7),
                lambda: run_soak(7, "leader-partition", horizon=2),
                lambda: run_wire_soak(7, "wire-leader-partition"),
                lambda: ChaosSearch(7, Corpus()),
                lambda: TrafficEngine(WorkloadSpec(tenants=1), 7),
                lambda: bench_podsim.bench_row(4, 2, ticks=1, warmup=1),
                lambda: bench_podsim.main(["--devices", "2", "--per-device", "4"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_chaos_and_traffic_params_live_on_the_host():
    """The chaos harness's module-level params are host tensors, so importing
    it allocates nothing on a device; the engines move them to their own."""
    from josefine_tpu_torch.chaos import harness

    for params in (harness.DEFAULT_PARAMS, harness.LEASE_PARAMS):
        assert {t.device.type for t in params.leaves()} == {"cpu"}


def test_traffic_driver_refuses_the_jax_backend():
    assert inspect.signature(TrafficEngine.__init__).parameters["backend"].default == "torch"
    with pytest.raises(ValueError, match="unknown engine backend 'jax'"):
        TrafficEngine(WorkloadSpec(tenants=1), 7, backend="jax", device="cpu")
