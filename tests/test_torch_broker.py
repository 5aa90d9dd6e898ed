"""PyTorch port, the broker (``josefine_tpu_torch/broker/``): the cases of
the JAX package's broker suites run against the port's copies.

* ``test_broker_state``: the metadata store and its FSM;
* ``test_broker_handlers``: the Kafka handlers over an instant raft client;
* ``test_log``: the native segment log, the record-batch framing and CRC32C;
* ``test_wire_fetch``: zero-copy fetch frames over both log backends, and the
  TCP server;
* ``test_durability``: the partition FSM's durable apply;
* ``test_idempotent_produce``: producer-id dedup, on three port nodes;
* ``test_partition_compaction``: partition snapshots and log rebuilds on
  port engines (``device="cpu"``).

``test_groups`` runs in ``test_torch_broker_groups.py``: its ``broker``
fixture differs from ``test_broker_handlers``'s by the same name. A case
that builds a node of the JAX package fails (``only_port_nodes``).
"""

from torch_parity import HOST, only_port_nodes, repointed  # noqa: F401

_ON_THE_HOST = [HOST["step_params"], HOST["RaftEngine"]]

_cases = [
    repointed("test_broker_state"),
    repointed("test_broker_handlers"),
    repointed("test_log"),
    repointed("test_wire_fetch"),
    repointed("test_durability"),
    repointed("test_idempotent_produce", edits=[HOST["NodeManager"]]),
    repointed("test_partition_compaction", edits=_ON_THE_HOST),
]
_names = [set(c) - {"broker"} for c in _cases]
assert sum(map(len, _names)) == len(set().union(*_names)), "two suites share a case name"
for _c in _cases:
    globals().update(_c)
