"""The window step's share of its memory roofline: the bytes its ticks
need (``benchmark/roofline.py``, frozen) over the card's HBM bandwidth,
divided by the kernel time of those ticks in the trace."""

from benchmark.roofline import HBM_BYTES_PER_S

UNIT = "%"
LAYER = "kernels"
MOVES = "commits_per_s"


def read(obs):
    t = obs.get("device_trace")
    peak = HBM_BYTES_PER_S.get(obs.get("device_kind"))
    if not t or not t["kernel_s"] or not peak or not obs.get("step_bytes"):
        return None
    return 100.0 * obs["step_bytes"] / peak / t["kernel_s"]
