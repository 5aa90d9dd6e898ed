"""p99 over every proposal made in the window, from ``propose`` to the
round that returned it answered (host clock); proposals open at the
window's end are answered after it and count."""

import numpy as np

UNIT = "ms"


def read(obs):
    lat = obs.get("latencies_ms")
    if not lat or "acked" not in obs:
        return None
    return float(np.percentile(np.asarray(lat, np.float64), 99))
