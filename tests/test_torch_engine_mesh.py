"""PyTorch port, the engine on a device mesh (``RaftEngine(mesh=...)``).

The JAX package's ``test_engine_mesh`` runs against the port on meshes of
CPU shards: mesh engine clusters equal to single-device ones tick for tick,
and three nodes with ``engine.mesh_shards = 2`` serving a replicated topic
over Kafka.

Then the twin across the packages: three JAX engines on an 8-shard 'p' mesh
of the conftest's virtual devices and three port engines on an 8-shard mesh
of the host, both with the active set and a ``RouteFabric`` with the payload
ring, driven through the schedule of the JAX package's
``tools/podsim_smoke.py`` (cold-start elections, a proposal drizzle on
groups 0 and 3, node 2 partitioned for ticks 15-29, group 2 recycled at
tick 40). On every tick the two sides must agree on everything
``test_torch_route.RoutedTwin`` compares (mirrors, state, chains, FSM
applies, wire bytes, the journal, the scheduler's counts, the member mask,
routed counts and the fabric itself) and on the per-shard wake split
(``_last_wake_shard``) and the ``raft_active_wake_fraction{shard=}``
gauges. A second case (``slow``: about 25 s) runs sparse IO with a
compaction capacity of 8, so the cold-start ticks overflow it (the dense
fetch from every shard).

Last, every scenario of ``test_torch_engine.py``'s twin cluster (restarts
from the KV, snapshot installs, conf changes, claims, recycles, migration,
leases) with the port's engines on a 2-shard mesh of the host against the
unsharded JAX engines: each out-of-tick row write must land in the owning
shard's block.
"""

from __future__ import annotations

import asyncio

import jax
import numpy as np
import pytest

import test_torch_engine
from josefine_tpu.utils.metrics import REGISTRY as JAX_REGISTRY
from josefine_tpu_torch.parallel.sharded import Mesh
from josefine_tpu_torch.utils.metrics import REGISTRY
from test_torch_route import RoutedTwin
from torch_parity import HOST, fresh_registries, only_port_nodes, repointed  # noqa: F401

_cases = [
    repointed("test_engine_mesh", edits=[
        ("from jax.sharding import Mesh\n",
         "from josefine_tpu_torch.parallel.sharded import Mesh\n"),
        ("from test_integration import NodeManager, make_batch",
         "from torch_parity import NodeManager, make_batch"),
        HOST["step_params"], HOST["RaftEngine"],
        ("    devs = jax.devices()\n", '    devs = ["cpu"] * 8\n'),
    ]),
]
for _c in _cases:
    globals().update(_c)


def _wake_gauges(registry) -> list[str]:
    """The per-shard wake-fraction series of a registry's exposition."""
    return sorted(line for line in registry.render_prometheus().splitlines()
                  if line.startswith("raft_active_wake_fraction{") and "shard=" in line)


class MeshTwin(RoutedTwin):
    """The routed twin with the JAX engines on a mesh of the virtual
    devices and the port's on a mesh of CPU shards."""

    def compare(self, what):
        super().compare(what)
        for i, ej, et in self.pairs():
            a, b = et._last_wake_shard, ej._last_wake_shard
            assert (a is None) == (b is None), f"{what} engine {i}"
            if a is not None:
                assert np.array_equal(a, b), f"{what} engine {i} wake split"
                if not et._sched_pending:
                    assert int(a.sum()) == et._last_wake_rows, f"{what} engine {i}"
        assert _wake_gauges(REGISTRY) == _wake_gauges(JAX_REGISTRY), what


async def _run_podsim_schedule(ticks=70, window=1, **kw):
    fresh_registries()
    S = 8
    twin = MeshTwin(
        payload_ring=True, groups=48, hb_ticks=8, active_set=True, fsm_groups=4,
        jax_kw=dict(mesh=jax.sharding.Mesh(np.array(jax.devices()[:S]), ("p",))),
        port_kw=dict(mesh=Mesh(np.array(["cpu"] * S), ("p",))), **kw)
    assert all(e._shards == S and e._shard_rows == 6 for e in twin.pt)
    for t in range(ticks):
        twin.cut = {2} if 15 <= t < 30 else set()
        if t % 5 == 0 and t > 10:
            for g in (0, 3):
                twin.propose(g, b"t%d-g%d" % (t, g))
        if t == 40:
            for e in twin.jx + twin.pt:
                e.recycle_group(2)
                e.set_group_incarnation(2, 1)
            twin.compare("after recycle")
        twin.step(window=window)
        await asyncio.sleep(0)
    assert sum(e.active_sched_ticks for e in twin.pt) > 0, "no compacted tick ran"
    assert twin.tfab.routed_total == twin.jfab.routed_total > 0
    assert len(_wake_gauges(REGISTRY)) == 3 * S
    return twin


async def test_mesh_twin_matches_jax_every_tick():
    twin = await _run_podsim_schedule()
    assert sum(len(f.applied) for f in twin.tfsms[0].values()) > 0


@pytest.mark.slow
async def test_mesh_twin_sparse_overflow_matches_jax_every_tick():
    """Sparse IO at a compaction capacity of 8: the cold-start fallback
    ticks change more rows than that, so they take the dense fetch from
    every shard, and the capacity grows as in the JAX engine."""
    twin = await _run_podsim_schedule(ticks=45, sparse_io=True, k_out=8)
    assert all(e._k_out > 8 for e in twin.pt), [e._k_out for e in twin.pt]


# The scenarios whose out-of-tick row writes differ most (snapshot install,
# restart from the KV, conf changes, migration, leases); the rest of the
# matrix is slow (claims re-place the member mask in the re-pointed
# test_member_stays_cosharded_after_claim_change).
_MESH_TIER1 = {"partition-snapshot-cap", "restart-from-kv", "conf-add-remove",
               "active-freeze-adopt-purge", "five-sparse-active-leases-kout8-window1"}


@pytest.mark.parametrize("name", [
    n if n in _MESH_TIER1 else pytest.param(n, marks=pytest.mark.slow)
    for n in test_torch_engine.SCENARIOS if "python" not in n])
async def test_engine_twin_scenarios_on_a_mesh(name, monkeypatch):
    """The engine twin's scenario with the port's engines sharded 2 ways
    over the host (the JAX engines unsharded)."""
    plain = test_torch_engine.Twin.__init__

    def on_a_mesh(self, *args, **kw):
        kw["port_kw"] = dict(kw.get("port_kw") or {},
                             mesh=Mesh(np.array(["cpu"] * 2), ("p",)))
        plain(self, *args, **kw)

    monkeypatch.setattr(test_torch_engine.Twin, "__init__", on_a_mesh)
    await test_torch_engine.SCENARIOS[name]()
