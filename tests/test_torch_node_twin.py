"""PyTorch port, the node twin: three JAX nodes (``backend="jax"``) and
three port nodes (``device="cpu"``), KV in memory, one ``LockstepPacer``
on the virtual clock, each cluster's raft sockets replaced by a
fixed-order hop, given one Kafka script
(``josefine_tpu_torch.node_lockstep.run_kafka_script``): CreateTopics (4
partitions, replication factor 3), Produce (``acks=-1``) of seeded record
batches to each partition's leader, the metadata leader stopped partway,
Fetch from every live replica, Metadata, ListOffsets, FindCoordinator,
OffsetCommit and OffsetFetch.

On every advance both clusters must have answered the same requests, with
equal Kafka answers, the raft wire must carry the same frames (client
request ids aside, as in the server twin), and every node must be equal in
its KV (the metadata
store and every durable record), its partition logs, its chains, its
``_h_*`` mirrors and its engine state. Nothing is masked: topic and
partition ids are drawn from one seeded generator per cluster, and both
clusters' configs name the same ports. At the end every acknowledged batch
is read back from every live replica at its offset, byte for byte. Run at
window 1 and at window 4 (pipelined, four ticks per advance while every
claimed group has a leader).
"""

import jax
import numpy as np

from josefine_tpu import config as jax_config
from josefine_tpu.broker import handlers as jax_handlers
from josefine_tpu.node import Node as JaxNode
from josefine_tpu.raft import rpc as jax_rpc
from josefine_tpu_torch import config, interop, node_lockstep
from josefine_tpu_torch.broker import handlers
from josefine_tpu_torch.node import Node
from josefine_tpu_torch.raft import lockstep, rpc
from josefine_tpu_torch.raft.pacer import LockstepPacer

JAX_KIT = node_lockstep.Kit(JaxNode, jax_config, jax_handlers, jax_rpc.decode_frame,
                            lambda e: [np.asarray(x) for x in jax.tree.leaves(e.state)])
PORT_KIT = node_lockstep.Kit(Node, config, handlers, rpc.decode_frame,
                             lambda e: interop.state_to_numpy(e.state))


def run_twin(tmp_path, step: int, **raft_extra) -> dict:
    async def main():
        pacer = LockstepPacer(settle_s=0)
        kits = [JAX_KIT, PORT_KIT]
        sides = node_lockstep.build_sides(kits, pacer, tmp_path, partitions=8, seed=11,
                                          raft_extra=raft_extra,
                                          engine_kws=[{"backend": "jax"}, {"device": "cpu"}])
        with node_lockstep.seeded(kits):
            return await node_lockstep.run_kafka_script(sides, pacer, seed=7, step=step)

    stats = lockstep.run(main())
    assert stats["stopped"] is not None and stats["acked"] == 4 * 4 and stats["frames"], stats
    # Every advance was compared; only a windowed run advances several ticks.
    assert stats["compared"] == stats["ticks"] - (step - 1) * stats["strided"], stats
    assert (step > 1) == bool(stats["strided"]), stats
    return stats


def test_twin_nodes_match_jax_every_advance(tmp_path):
    run_twin(tmp_path, step=1)


def test_twin_nodes_windowed_pipelined_match_jax_every_advance(tmp_path):
    run_twin(tmp_path, step=4, window_ticks=4, pipeline_ticks=True)


def test_seeded_ids_draw_per_side():
    """Inside ``seeded``, ``uuid4`` in a side's call draws from that side's
    generator; outside any call it is the real one."""
    import contextvars
    import random

    side = node_lockstep.NodeSide(PORT_KIT, [], None, random.Random(3))
    twin = node_lockstep.NodeSide(PORT_KIT, [], None, random.Random(3))
    with node_lockstep.seeded([PORT_KIT]):
        ids = []
        for s in (side, twin):
            ctx = contextvars.copy_context()
            ctx.run(node_lockstep._SIDE.set, s)
            ids.append(ctx.run(handlers.uuid.uuid4))
        assert ids[0] == ids[1] and ids[0].version == 4
        assert handlers.uuid.uuid4() != handlers.uuid.uuid4()
    assert handlers.uuid.uuid4.__module__ == "uuid"
