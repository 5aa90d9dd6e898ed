"""PyTorch port, the observability planes under chaos and traffic: the cases
of the JAX package's flight-recorder, timeline, health and span suites run
against the port, every engine on the host (``device="cpu"``).

* ``test_flight``: engine journals and the soak's journal determinism and
  violation artifact;
* ``test_flight_merge``: the merged cluster timeline and the trace report
  read from a port soak's artifact (``tools/trace_report.py``);
* ``test_health``: the health plane, its soak twin and the doctor
  (``tools/doctor.py``);
* ``test_spans``: request spans on the engine, the traffic driver and the
  chaos soak.
"""

from torch_parity import HOST, repointed

_cases = [
    repointed("test_flight", edits=[HOST["run_soak"], HOST["step_params"],
                                    HOST["RaftEngine"]]),
    repointed("test_flight_merge", edits=[HOST["run_soak"], HOST["step_params"],
                                          HOST["RaftEngine"]]),
    repointed("test_health", edits=[HOST["run_soak"]]),
    repointed("test_spans", edits=[HOST["run_soak"], HOST["step_params"], HOST["RaftEngine"],
                                   HOST["TrafficEngine"]]),
]
_names = [set(c) for c in _cases]
assert sum(map(len, _names)) == len(set().union(*_names)), "two suites share a case name"
for _c in _cases:
    globals().update(_c)
