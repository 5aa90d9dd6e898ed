"""PyTorch port, the workload plane (``josefine_tpu_torch/workload/``): the
cases of the JAX package's ``test_workload`` (the tenant model, arrivals,
the trace, the in-process traffic driver, chaos under workload traffic and
the wire driver) and ``test_group_recycling`` (topic churn recycling engine
rows, with the traffic driver under churn) run against the port, every
engine on the host (``device="cpu"``).
"""

from torch_parity import HOST, only_port_nodes, repointed  # noqa: F401

_cases = [
    repointed("test_workload", edits=[HOST["TrafficEngine"], HOST["run_soak"],
                                      HOST["NodeManager"]]),
    repointed("test_group_recycling", edits=[HOST["step_params"], HOST["RaftEngine"],
                                             HOST["NodeManager"], HOST["TrafficEngine"]]),
]
_names = [set(c) - {"only_port_nodes"} for c in _cases]
assert sum(map(len, _names)) == len(set().union(*_names)), "two suites share a case name"
for _c in _cases:
    globals().update(_c)
