"""Deterministic chaos: the reusable fault plane for this repository.

The reference josefine has no fault-injection framework at all (SURVEY.md
§5 — its safety story is typestates plus unit tests). Here chaos is a
first-class subsystem:

* :mod:`josefine_tpu.chaos.faults` — :class:`FaultPlane`, a seed-driven
  virtual-tick fault engine (message drop/duplicate/delay/reorder,
  symmetric and asymmetric partitions, node crash/restart directives,
  disk faults), plus the hook adapters the product stack opts into.
* :mod:`josefine_tpu.chaos.nemesis` — named, composable fault schedules
  with a JSON-serializable DSL (``leader-partition``, ``crash-loop``, ...).
* :mod:`josefine_tpu.chaos.invariants` — the Raft safety checkers
  (election safety, durability, log matching, convergence,
  linearizability) shared by tests, the soak CLI, and CI.
* :mod:`josefine_tpu.chaos.harness` — in-process cluster harnesses that
  wire engines to a fault plane.
* :mod:`josefine_tpu.chaos.soak` — the programmatic soak runner behind
  ``tools/chaos_soak.py``.
* :mod:`josefine_tpu.chaos.search` — coverage-guided schedule search
  (seeded mutation of nemesis schedules + workload knobs, novelty scoring
  against a persistent corpus, ddmin repro minimization) behind
  ``tools/chaos_search.py``.

The product stack never imports this package: hooks in
``raft/tcp.py`` / ``utils/kv.py`` / ``broker/log.py`` default to None and
no fault-plane object exists unless a test or the soak tool constructs one.
"""

from josefine_tpu_torch.chaos.faults import FaultPlane, NetFaults  # noqa: F401
from josefine_tpu_torch.chaos.nemesis import SCHEDULES, Nemesis, Schedule  # noqa: F401
