"""Run a cell's control on the card and print what the comparison reads.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds <s>

The control breaks one guarantee the cell's configuration states (see
each driver's docstring); the comparison has to read it as not correct.
One JSON line per seed: its ``correct`` and every number compared. The
benchmark's own runs never run it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    for seed in (int(s) for s in args.seeds.split(",")):
        line, _ = harness.execute(args.workload, seed, args.seconds, False,
                                  torch.device("cuda", 0), time.perf_counter(), control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": True,
                          "correct": line["correct"], "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
