"""The share of the window's engine ticks on which the active-set
scheduler fell back to the sparse step (more than half the groups awake):
``active_fallback_ticks`` over it and ``active_sched_ticks``, summed over
the 5 engines (``raft/engine.py`` counters)."""

UNIT = "%"
LAYER = "engine host (raft/engine.py)"
MOVES = "commits_per_s"


def read(obs):
    s = obs.get("scheduler")
    if not s or s.get("active_fallback_ticks") is None or s.get("active_sched_ticks") is None:
        return None
    n = s["active_fallback_ticks"] + s["active_sched_ticks"]
    return 100.0 * s["active_fallback_ticks"] / n if n else None
