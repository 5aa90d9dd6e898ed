"""PyTorch port, TCP transport: the cases of ``tests/test_tcp_coalesce.py``
(newest-wins coalescing of consensus batches per peer) run against the
port's copy of ``raft/tcp.py``."""

from torch_parity import repointed

globals().update(repointed("test_tcp_coalesce"))
