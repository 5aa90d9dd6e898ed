"""Same-call comparison of the plain PyTorch window in two source trees.

The plain window (``fused_step.run_ticks_fused_ref``: ``run_ticks`` over
``node_step``, the fused-window kernel's reference) is ~1,000 host-dispatched
ops per tick, so its time follows the host's speed, which varies between
machines. Comparing two versions of it is only fair inside one run::

    python -m josefine_tpu_torch.plain_ab ROOT_A ROOT_B [--ticks 500]

Each measurement runs in a process of its own that imports
``josefine_tpu_torch`` from the given root, builds the headline's state
(P = 100,000 groups of N = 5, seed 0, the bench's step params), runs one
20-tick warmup window, and times one ``ticks``-tick window with CUDA events
on the card. The runs go A, B, B, A, so a drift of the host's speed shows as
a difference between the two A runs. Prints one JSON line per run, then one
summary line. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

_MEASURE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from josefine_tpu_torch import bench
from josefine_tpu_torch.models import chained_raft as cr
from josefine_tpu_torch.models.types import step_params
from josefine_tpu_torch.ops import fused_step

ticks, dev = int(sys.argv[2]), torch.device("cuda", 0)
P, N = 100_000, 5
params = step_params(timeout_min=5, timeout_max=10, hb_ticks=1,
                     auto_proposals=bench.PROPOSALS_PER_TICK, device=dev)
st, member = cr.init_state(P, N, base_seed=0, params=params, device=dev)
ib = cr.empty_inbox(P, N, device=dev)
props = torch.zeros((P, N), dtype=torch.int32, device=dev)
st, ib, _ = fused_step.run_ticks_fused_ref(params, member, st, ib, props, 20)
a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
torch.cuda.synchronize()
a.record()
fused_step.run_ticks_fused_ref(params, member, st, ib, props, ticks)
b.record()
torch.cuda.synchronize()
print(json.dumps({"root": sys.argv[1], "source": cr.__file__, "ticks": ticks,
                  "plain_ms": a.elapsed_time(b), "card": bench.card_label()}))
"""


def measure(root: str, ticks: int) -> dict:
    out = subprocess.run([sys.executable, "-c", _MEASURE, root, str(ticks)],
                         capture_output=True, text=True, check=True, timeout=900)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--ticks", type=int, default=500)
    args = ap.parse_args(argv)
    runs = []
    for root in (args.root_a, args.root_b, args.root_b, args.root_a):
        runs.append(measure(root, args.ticks))
        print(json.dumps(runs[-1]), flush=True)
    ms = {r: [x["plain_ms"] for x in runs if x["root"] == r] for r in (args.root_a, args.root_b)}
    print(json.dumps({"ticks": args.ticks, "plain_ms": ms, "card": runs[0]["card"]}))


if __name__ == "__main__":
    main()
