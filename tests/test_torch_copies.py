"""Drift guard for the host-only modules the PyTorch port copies.

These modules import no JAX, but the port may not import the JAX package
at all, so it carries its own copies. Each copy must stay the JAX module's
source with ``josefine_tpu.`` rewritten to ``josefine_tpu_torch.`` on its
import lines, and nothing else: a fix to either side that is not made to
the other fails here.
"""

import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
MODULES = [
    "utils/tracing.py", "utils/kv.py", "utils/metrics.py", "utils/profiling.py",
    "utils/flight.py", "utils/spans.py", "utils/health.py",
    "raft/membership.py", "raft/chain.py", "raft/rpc.py", "raft/fsm.py",
    "raft/result.py", "raft/migration.py", "raft/lease.py",
]
# Deliberate differences between a copy and its original, by module, with
# the reason. There are none.
DIFFERENCES: dict[str, str] = {}
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)josefine_tpu\.", re.M)


@pytest.mark.parametrize("module", MODULES)
def test_copy_equals_original_with_imports_repointed(module):
    assert module not in DIFFERENCES
    original = (REPO / "josefine_tpu" / module).read_text()
    copy = (REPO / "josefine_tpu_torch" / module).read_text()
    assert copy == _IMPORT.sub(r"\1josefine_tpu_torch.", original), (
        f"josefine_tpu_torch/{module} has drifted from josefine_tpu/{module}")
