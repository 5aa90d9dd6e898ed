"""PyTorch port, live migration and leader leases under chaos: the cases of
the JAX package's ``test_migration`` (row-to-row handoff on engines, the
routed twin mid-pipelined dispatch, migration soaks, a migration through
the metadata FSM on three nodes, the traffic driver's migration) and
``test_lease_safety`` (lease grants, expiry, the routed and pipelined
twins, the leases-on against leases-off twin on a two-shard mesh, lease
soaks) run against the port, every engine on the host (``device="cpu"``). The helpers they take from ``test_device_route``,
``test_active_set``, ``test_integration`` and ``test_partition_groups``
come from those suites re-pointed at the port (``torch_parity``).
"""

from torch_parity import HOST, only_port_nodes, repointed  # noqa: F401

_cases = [
    repointed("test_migration", edits=[
        HOST["step_params"], HOST["RaftEngine"], HOST["run_soak"], HOST["TrafficEngine"],
        HOST["NodeManager"],
        ("from test_device_route import (_assert_engines_equal, _wire_key,",
         "from torch_parity import (_assert_engines_equal, _wire_key,"),
        ("from test_partition_groups import _create, _wait_partitions",
         "from torch_parity import _create, _wait_partitions"),
    ]),
    repointed("test_lease_safety", edits=[
        HOST["step_params"], HOST["RaftEngine"],
        ("from test_active_set import ListFsm, _wire_key",
         "from torch_parity import ListFsm, _wire_key"),
        ("from test_device_route import _assert_engines_equal",
         "from torch_parity import _assert_engines_equal"),
        # The sharded twin's mesh: two shards of the host.
        ("from jax.sharding import Mesh\n",
         "from josefine_tpu_torch.parallel.sharded import Mesh\n"),
        ("        devs = jax.devices()\n", '        devs = ["cpu"] * 8\n'),
    ], everywhere=[HOST["run_soak"]]),
]
_names = [set(c) - {"only_port_nodes"} for c in _cases]
assert sum(map(len, _names)) == len(set().union(*_names)), "two suites share a case name"
for _c in _cases:
    globals().update(_c)
