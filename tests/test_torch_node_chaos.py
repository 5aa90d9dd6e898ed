"""PyTorch port, whole-node chaos: the cases of the JAX package's
``test_node_chaos`` run against the port. Three port nodes (engines on the
host, durable sqlite KV and segment logs, real sockets) are crashed and
restarted on a seeded fault plane while a client produces; every
acknowledged record must survive, in order, on every replica.
"""

from torch_parity import NODE_CHAOS_EDITS, only_port_nodes, repointed  # noqa: F401

globals().update(repointed("test_node_chaos", edits=NODE_CHAOS_EDITS))
