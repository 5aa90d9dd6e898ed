"""Scale-out: shard the (partitions, nodes) state over a mesh of devices.

The partition axis is embarrassingly parallel (independent Raft groups); the
node axis puts the members of one consensus group on different devices, and
message delivery becomes an all_to_all over them. One process drives every
shard (see :mod:`josefine_tpu_torch.parallel.sharded`).
"""

from josefine_tpu_torch.parallel.sharded import (
    make_mesh,
    state_spec,
    place,
    make_sharded_cluster_step,
)

__all__ = ["make_mesh", "state_spec", "place", "make_sharded_cluster_step"]
