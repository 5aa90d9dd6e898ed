"""PyTorch port, the chaos plane (``josefine_tpu_torch/chaos/``,
``utils/coverage.py``): the cases of the JAX package's chaos suites run
against the port's copies, every engine on the host (``device="cpu"``).

* ``test_chaos``: the in-process chaos cluster, with membership churn and
  over the sparse bridge;
* ``test_chaos_determinism``: same seed, same soak, byte for byte;
* ``test_coverage``: the coverage map and its signatures;
* ``test_fault_hooks``: the fault plane's disk, log and transport hooks.
"""

from torch_parity import HOST, repointed

_cases = [
    repointed("test_chaos", edits=[
        ("from josefine_tpu_torch.chaos.harness import ChaosCluster, MembershipChaosCluster",
         "from torch_parity import HostChaosCluster as ChaosCluster\n"
         "from torch_parity import HostMembershipChaosCluster as MembershipChaosCluster"),
    ]),
    repointed("test_chaos_determinism", edits=[HOST["run_soak"]]),
    repointed("test_coverage"),
    repointed("test_fault_hooks"),
]
_names = [set(c) for c in _cases]
assert sum(map(len, _names)) == len(set().union(*_names)), "two suites share a case name"
for _c in _cases:
    globals().update(_c)
