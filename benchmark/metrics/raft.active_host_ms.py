"""Host ms per round of the active-set scheduler's own phases over the 5
engines: ``compact`` (the wake predicate, the refetch after a fallback and
the gather), ``scatter`` (the step's rows back, fused with the idle decay)
and ``decay`` (the host twin of the decay on the timer mirrors)
(``raft/engine.py``, ``PhaseProfiler``)."""

UNIT = "ms"
LAYER = "engine host (raft/engine.py)"
MOVES = "commits_per_s"
PHASES = ("compact", "scatter", "decay")


def read(obs):
    ph = obs.get("phases")
    if not ph or "compact" not in ph or not obs.get("rounds"):
        return None
    return sum(ph.get(p, 0.0) for p in PHASES) / obs["rounds"]
