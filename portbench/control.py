"""The control of ``correct``, on the card at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 5

Each seed runs the cell as a benchmark run does (set-up, a window of
``--seconds``, the check), with the reference at the next precision below
the configuration's (bf16 for fp32 storage, int4 for int8) put in the
program's place for the check, so that ``correct`` judges the control's
answers. Prints one JSON line per seed: ``correct`` and the control's
``checks``, the upper readings that the limits in the cell's file lie below.
Exits 1 where a control came out correct.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness
    from portbench.reference import CONTROL_OF

    harness.cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    storage = harness.configuration(harness.workload(args.workload)["config"])["storage"]
    passed = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               control=CONTROL_OF[storage])
        passed += res["correct"]
        line = {"workload": args.workload, "seed": seed, "control": CONTROL_OF[storage],
                "correct": res["correct"],
                "checks": {k: c["value"] for k, c in res["checks"].items()},
                "failing": sorted(k for k, c in res["checks"].items()
                                  if c["value"] > c["limit"])}
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
