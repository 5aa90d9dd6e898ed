"""Round by round through the keyed benchmark cell
(``raft100k5-active.ycsb_zipf099``), at full size on a card.

Default: after the cell's election and warm-up, time ``--rounds`` closed
rounds with the engines' profilers on, and print one JSON line per kind of
round (normal, heartbeat, fallback, re-entry) with its count, mean ms, the
engine ticks' most common modes (``C<K>`` compacted into a bucket of ``K``
rows, ``F`` sparse fallback, ``r`` a timer refetch) and each phase's mean
host ms over the 5 engines; then the sequence of kinds, each round's ms
and the timed proposals' latency percentiles.

``--misroute``: one run of the cell through the harness in which, from
the window on, every even key goes to the next group; prints the checks,
which have to catch it (``misplaced`` > 0).

Run from the root of a checkout::

    python3 tools/keyed_rounds.py --seed 3100000031 --rounds 64
    python3 tools/keyed_rounds.py --seed 3100000029 --misroute --seconds 10
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import pathlib
import sys
import time
from collections import Counter

T0 = time.perf_counter()
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

CELL = "raft100k5-active.ycsb_zipf099"


def _misrouted(cl) -> None:
    real = cl.partition
    cl.partition = lambda n: np.where(n % 2 == 0, real(n) % (cl.P - 1) + 1, real(n))


def misroute(seed: int, seconds: float, dev: torch.device) -> dict:
    from benchmark import harness

    line, _ = harness.execute(CELL, seed, seconds, False, dev, T0, fault=_misrouted)
    return {"fault": "misrouted_even_keys", "seed": seed, "correct": line["correct"],
            "checks": {k: c["value"] for k, c in line["checks"].items()}}


def _kind(modes: list[str]) -> str:
    if any(m.startswith("F") for m in modes):
        return "fallback"
    if any(m.endswith("r") for m in modes):
        return "re-entry"
    if max(int(m[1:].rstrip("r")) for m in modes) > 8192:
        return "heartbeat"
    return "normal"


async def _rounds(seed: int, n_rounds: int, dev: torch.device, groups: int | None):
    from benchmark import harness
    from benchmark.drivers import engine_rounds as base
    from benchmark.drivers import engine_rounds_keyed as keyed

    spec = harness.load_spec()
    cell = harness.find_cell(spec, CELL)
    cfg = harness.load_config(spec, cell)
    tr = harness.load_traffic(cell["traffic"])
    if groups:
        cfg = dict(cfg, groups=groups)
    cl = keyed.KeyedCluster(cfg, seed, dev, False)
    prod = keyed.Producer(tr, seed)
    book = base.Book()
    for r in range(400):
        cl.round()
        if r % 4 == 3 and (cl.leaders_per_group() == 1).all():
            break
    for _ in range(tr["warmup_rounds"]):
        prod.offer(cl, book, False)
        cl.round()
        book.settle()
    for e in cl.engines:
        e.enable_profiling().reset()
    gc.collect()

    def phases() -> dict:
        out: dict[str, float] = {}
        for e in cl.engines:
            for k, s in e.profiler.snapshot().items():
                out[k] = out.get(k, 0.0) + s["total_ms"]
        return out

    rows = []
    for _ in range(n_rounds):
        seen = [(e.active_fallback_ticks, e.active_refetches) for e in cl.engines]
        p0, t0 = phases(), time.perf_counter()
        prod.offer(cl, book, True)
        cl.round()
        book.settle()
        ms = 1e3 * (time.perf_counter() - t0)
        modes = []
        for e, (f, rf) in zip(cl.engines, seen):
            m = "F" if e.active_fallback_ticks > f else "C%d" % e._last_bucket_k
            modes.append(m + ("r" if e.active_refetches > rf else ""))
        ph = {k: v - p0.get(k, 0.0) for k, v in phases().items()
              if not k.startswith("commit_")}
        rows.append({"ms": ms, "modes": modes, "phases": ph})
    lat = [(book.t_done[i] - book.t_sent[i]) * 1e3 for i in range(len(book.group))
           if book.timed[i] and book.status[i] == "acked"]
    return rows, lat


def rounds(seed: int, n_rounds: int, dev: torch.device, groups: int | None = None) -> list[str]:
    rows, lat = asyncio.run(_rounds(seed, n_rounds, dev, groups))
    kinds: dict[str, list] = {}
    for row in rows:
        kinds.setdefault(_kind(row["modes"]), []).append(row)
    lines = []
    for kind, rs in kinds.items():
        names = {p for row in rs for p in row["phases"]}
        mean = {p: round(float(np.mean([row["phases"].get(p, 0.0) for row in rs])), 2)
                for p in names}
        mean = dict(sorted(((p, v) for p, v in mean.items() if v >= 0.05),
                           key=lambda kv: -kv[1]))
        lines.append(json.dumps({"kind": kind, "n": len(rs),
                                 "ms": round(float(np.mean([row["ms"] for row in rs])), 1),
                                 "modes": list(Counter(tuple(row["modes"]) for row in rs)
                                               .most_common(1)[0][0]),
                                 "phases": mean}))
    marks = {"fallback": "F", "re-entry": "R", "heartbeat": "H", "normal": "."}
    lines.append("sequence " + "".join(marks[_kind(row["modes"])] for row in rows))
    lines.append("round_ms %s" % [round(row["ms"]) for row in rows])
    if lat:
        lines.append("latency_ms p50 p90 p99 max %s"
                     % np.percentile(lat, [50, 90, 99, 100]).round(1).tolist())
    return lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=64)
    ap.add_argument("--groups", type=int, default=None,
                    help="groups in place of the configuration's, for a small run")
    ap.add_argument("--misroute", action="store_true")
    ap.add_argument("--seconds", type=float, default=10.0, help="the window, with --misroute")
    args = ap.parse_args()
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    if args.misroute:
        print(json.dumps(misroute(args.seed, args.seconds, dev)))
    else:
        print("\n".join(rounds(args.seed, args.rounds, dev, args.groups)))


if __name__ == "__main__":
    main()
