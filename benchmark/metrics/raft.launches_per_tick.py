"""Device kernels per engine tick in the traced rounds (copies and fills
not counted)."""

UNIT = "launches/tick"
LAYER = "window step (raft/packed_step.py)"
MOVES = "commits_per_s"


def read(obs):
    t = obs.get("device_trace")
    if not t or not t["kernels"] or not obs.get("traced_engine_ticks"):
        return None
    return t["kernels"] / obs["traced_engine_ticks"]
