"""Host-side Raft runtime of the PyTorch port.

The device step (:mod:`josefine_tpu_torch.models.chained_raft`) owns all
fixed-width consensus metadata: terms, votes, roles, head/commit ids, quorum
math. This package owns everything variable-length and durable around it:

* :mod:`josefine_tpu_torch.raft.chain`: the block DAG with payloads, commit
  pointer, dead-branch GC;
* :mod:`josefine_tpu_torch.raft.fsm`: the Fsm protocol and the driver that
  applies committed blocks;
* :mod:`josefine_tpu_torch.raft.engine`: the per-node bridge. It packs
  received wire messages into the inbox, steps the device, decodes the
  outbox into wire messages with payload spans attached, and applies newly
  committed blocks to the FSM;
* :mod:`josefine_tpu_torch.raft.route`: device-resident delivery between
  co-located engines (``RouteFabric``);
* :mod:`josefine_tpu_torch.raft.payload_ring`: the bounded device payload
  ring behind ``RouteFabric(payload_ring=True)``, so AppendEntries with
  ring-resident spans route on the device too;
* :mod:`josefine_tpu_torch.raft.lease`: tick-denominated leader leases
  (``RaftEngine(leases=True)``);
* :mod:`josefine_tpu_torch.raft.server`: one node's runtime
  (``JosefineRaft``): the tick loop on a pacer's cadence
  (:mod:`josefine_tpu_torch.raft.pacer`), the TCP transport
  (:mod:`josefine_tpu_torch.raft.tcp`) and client proposals routed to the
  leader; :mod:`josefine_tpu_torch.raft.client` is the in-process handle;
* :mod:`josefine_tpu_torch.raft.lockstep`: a deterministic harness for
  in-process clusters of servers (a virtual clock and a fixed-order hop in
  place of the sockets).
"""

from josefine_tpu_torch.raft.chain import Block, Chain
from josefine_tpu_torch.raft.client import RaftClient
from josefine_tpu_torch.raft.fsm import Fsm, Driver
from josefine_tpu_torch.raft.engine import NotLeader, RaftEngine
from josefine_tpu_torch.raft.payload_ring import PayloadRing
from josefine_tpu_torch.raft.route import RouteFabric
from josefine_tpu_torch.raft.server import JosefineRaft, ProposalTimeout

__all__ = ["Block", "Chain", "Fsm", "Driver", "RaftEngine", "NotLeader", "PayloadRing",
           "RouteFabric", "JosefineRaft", "ProposalTimeout", "RaftClient"]
