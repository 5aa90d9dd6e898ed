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
  committed blocks to the FSM.

The route fabric and payload ring of the JAX package are not ported yet.
"""

from josefine_tpu_torch.raft.chain import Block, Chain
from josefine_tpu_torch.raft.fsm import Fsm, Driver
from josefine_tpu_torch.raft.engine import RaftEngine

__all__ = ["Block", "Chain", "Fsm", "Driver", "RaftEngine"]
