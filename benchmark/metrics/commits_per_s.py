"""Proposals answered without error inside the window, over its seconds."""

UNIT = "commits/s"


def read(obs):
    if "acked" not in obs or "window_s" not in obs or "latencies_ms" not in obs:
        return None
    return obs["acked"] / obs["window_s"]
