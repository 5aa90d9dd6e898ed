"""PyTorch port against the JAX package, the chaos soak: the same seed and
schedule through the JAX ``run_soak`` and the port's (engines on the host)
must give equal artifacts, exactly (consensus admits no tolerance): the
fault-event log, every node's flight journal, the merged timeline, the
coverage map and signature, the final state digest, proposed and acked
counts, the health verdicts, the route and active-set statistics, the
workload and lease and migration epilogues, and every other field of the
result. The process-global metrics registries are zeroed, and the engines
of earlier runs collected (their scrape hooks die with them), before each
run; the dumps must agree on every metric both packages registered, and a
metric that only one package's process registered must have recorded
nothing. The wire soak (three nodes over real sockets) must give equal
wire event logs, fate logs and per-connection journals.
"""

from __future__ import annotations

import json
import os

import pytest

from josefine_tpu.chaos.faults import NetFaults as JaxNetFaults
from josefine_tpu.chaos.nemesis import Schedule as JaxSchedule
from josefine_tpu.chaos.soak import run_soak as jax_run_soak
from josefine_tpu.chaos.wire_soak import run_wire_soak as jax_run_wire_soak
from josefine_tpu_torch.chaos.faults import NetFaults
from josefine_tpu_torch.chaos.nemesis import Schedule
from josefine_tpu_torch.chaos.soak import run_soak
from josefine_tpu_torch.chaos.wire_soak import run_wire_soak

from torch_parity import fresh_registries

# ``tests/test_chaos_determinism.py``'s compressed leader partition: one
# leader isolation and one crash.
SHORT = json.dumps({"name": "short-mixed", "horizon": 120, "heal_ticks": 100, "steps": [
    {"at": 40, "op": "isolate", "target": "leader", "for": 25},
    {"at": 80, "op": "crash", "node": 1, "for": 20},
]})

# Artifacts a failure names first, in this order; then every other field.
ARTIFACTS = ("invariants", "violation", "event_log", "journals", "timeline",
             "coverage_signature", "coverage", "state_digest", "proposed", "acked",
             "health", "device_route_stats", "active_set_stats", "workload_stats",
             "lease", "migration")


def _empty(value) -> bool:
    """A registry dump entry that recorded nothing."""
    if isinstance(value, dict):
        return all(_empty(v) for v in value.values())
    return not value


def assert_registries_equal(got: dict, want: dict) -> None:
    for name in sorted(set(got) | set(want)):
        if name in got and name in want:
            assert got[name] == want[name], f"registry {name}: port {got[name]} jax {want[name]}"
        else:
            only = got.get(name, want.get(name))
            assert _empty(only), f"registry {name} only on one side, not empty: {only}"


def assert_results_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key in (*ARTIFACTS, *sorted(set(want) - set(ARTIFACTS) - {"registry_dump"})):
        assert got[key] == want[key], f"{key} differs: port {got[key]!r:.300} jax {want[key]!r:.300}"
    assert_registries_equal(got["registry_dump"], want["registry_dump"])


def soak_twin(seed: int, schedule: str, quiet: bool = False, **kw) -> dict:
    """The soak through both packages (on fresh registries); the port's
    result, after asserting it equals the JAX result."""
    fresh_registries()
    want = jax_run_soak(seed, JaxSchedule.from_json(schedule) if schedule == SHORT
                        else schedule, net=JaxNetFaults.quiet() if quiet else None,
                        artifact_path=os.devnull, **kw)
    fresh_registries()
    got = run_soak(seed, Schedule.from_json(schedule) if schedule == SHORT else schedule,
                   net=NetFaults.quiet() if quiet else None, artifact_path=os.devnull,
                   device="cpu", **kw)
    assert_results_equal(got, want)
    return got


@pytest.mark.parametrize("seed,schedule,kw", [
    pytest.param(1234, SHORT, {}, id="short"),
    pytest.param(1234, SHORT, dict(window=4, active_set=True, hb_ticks=4, groups=8),
                 id="window4-active-set"),
    pytest.param(7, SHORT, dict(quiet=True, device_route=True, payload_ring=True, groups=4,
                                workload={"tenants": 4, "produce_per_tick": 2.0}),
                 id="route-ring-quiet-workload"),
    pytest.param(11, "lease-expiry-under-partition", dict(leases=True), id="leases"),
    pytest.param(11, "migrate-leader-partition", dict(migration=True), id="migration"),
])
def test_soak_twin(seed, schedule, kw):
    got = soak_twin(seed, schedule, **kw)
    assert got["invariants"] == "ok", got["violation"]
    assert got["acked"] > 0 and got["fault_events"] > 0
    if kw.get("active_set"):
        assert got["active_set_stats"]["compacted_ticks"] > 0
    if kw.get("device_route"):
        assert got["device_route_stats"]["routed_msgs"] > 0
        assert got["workload_stats"]["acked"] > 0
    if kw.get("leases"):
        assert got["lease"]["leased_reads"] > 0
    if kw.get("migration"):
        assert got["migration"]["outcomes"].get("cutover", 0) >= 1


def test_wire_soak_twin():
    """Seed 7, ``wire-leader-partition`` on three nodes over real sockets
    (the wire chaos smoke): equal fate logs, wire event logs, journals and
    coverage; every acknowledged produce read back."""
    want = jax_run_wire_soak(7, "wire-leader-partition", n_nodes=3, tenants=2,
                             artifact_path=os.devnull)
    got = run_wire_soak(7, "wire-leader-partition", n_nodes=3, tenants=2,
                        artifact_path=os.devnull, device="cpu")
    for key in ("invariants", "violation", "fate_log", "event_log", "journals",
                "fault_event_log", "coverage_signature", "offered", "produced", "consumed",
                "health"):
        assert got[key] == want[key], f"{key} differs: port {got[key]!r:.300} jax {want[key]!r:.300}"
    assert got["invariants"] == "ok", got["violation"]
    assert got["produced"] > 0 and got["consumed"] == got["produced"]
