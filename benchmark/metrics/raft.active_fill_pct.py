"""How full the compacted ticks' buckets were: the active rows stepped
(``active_sched_rows``) over the power-of-two bucket rows gathered for
them (``active_bucket_rows``), over the window and the 5 engines
(``raft/engine.py`` counters; None on a program without the bucket
counter)."""

UNIT = "%"
LAYER = "window step (raft/packed_step.py)"
MOVES = "commits_per_s"


def read(obs):
    s = obs.get("scheduler")
    if not s or s.get("active_sched_rows") is None or not s.get("active_bucket_rows"):
        return None
    return 100.0 * s["active_sched_rows"] / s["active_bucket_rows"]
