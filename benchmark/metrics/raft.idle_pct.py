"""The card's idle share of the traced rounds: 100 x (1 - union of the
device's busy intervals / traced wall time)."""

UNIT = "%"
LAYER = "device"
MOVES = "commits_per_s"


def read(obs):
    t = obs.get("device_trace")
    if not t or not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
