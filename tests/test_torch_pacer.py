"""PyTorch port, tick pacing: the cases of ``tests/test_pacer.py`` run
against the port's copy of ``raft/pacer.py``."""

from torch_parity import repointed

globals().update(repointed("test_pacer"))
