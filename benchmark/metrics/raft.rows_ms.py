"""Host ms per round of the engines' per-row work in ``tick_finish``:
``decode`` and ``apply``, summed over the engines."""

UNIT = "ms"
LAYER = "engine host (raft/engine.py)"
MOVES = "commits_per_s"


def read(obs):
    ph = obs.get("phases")
    if not ph or "decode" not in ph or "apply" not in ph or not obs.get("rounds"):
        return None
    return (ph["decode"] + ph["apply"]) / obs["rounds"]
