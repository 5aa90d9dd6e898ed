"""Host ms per round of the engines' ``dispatch`` phase (enqueueing the
window step, ``raft/engine.py`` ``tick_begin``), summed over the engines."""

UNIT = "ms"
LAYER = "engine host (raft/engine.py)"
MOVES = "commits_per_s"


def read(obs):
    ph = obs.get("phases")
    if not ph or "dispatch" not in ph or not obs.get("rounds"):
        return None
    return ph["dispatch"] / obs["rounds"]
