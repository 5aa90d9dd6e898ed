"""PyTorch port, coverage-guided chaos search and chaos on the wire: the
cases of the JAX package's ``test_chaos_search`` (the schedule DSL, the
mutator, the corpus, seeded search from the committed corpus fixture, the
committed repro) and ``test_wire_chaos`` (the wire fault plane, wire soaks
over real sockets, wire-mode search) run against the port, every engine on
the host (``device="cpu"``).
"""

from torch_parity import HOST, only_port_nodes, repointed  # noqa: F401

_SEARCH_ON_THE_HOST = [
    ("from josefine_tpu_torch.chaos.search import (\n    ChaosSearch,\n",
     "from torch_parity import HostChaosSearch as ChaosSearch\n"
     "from josefine_tpu_torch.chaos.search import (\n"),
]
_cases = [
    repointed("test_chaos_search", edits=[*_SEARCH_ON_THE_HOST, HOST["run_soak"]]),
    repointed("test_wire_chaos", everywhere=[
        HOST["run_wire_soak"], HOST["NodeManager"],
        ("from test_integration import NodeManager, make_batch\n",
         "from torch_parity import NodeManager, make_batch\n"),
        ("from josefine_tpu_torch.chaos.search import ChaosSearch, Corpus\n",
         "from torch_parity import HostChaosSearch as ChaosSearch\n"
         "    from josefine_tpu_torch.chaos.search import Corpus\n"),
    ]),
]
_names = [set(c) - {"only_port_nodes"} for c in _cases]
assert sum(map(len, _names)) == len(set().union(*_names)), "two suites share a case name"
for _c in _cases:
    globals().update(_c)
