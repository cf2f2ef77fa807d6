"""The control of a cell's comparison, on the card at the cell's own size.

    python3 bench/control.py --workload <name> --seeds a,b,c --seconds <s>

For each seed, one run of the cell (as ``bench/run.py`` makes it) whose
judged queries are answered twice more by the plain reference itself:
once as the judge reads it, and once as the control, with the dot
products' operands rounded to TF32 (float32 with TF32 on, the precision
below the configuration's float32).  Prints one JSON line a seed with
the program's numbers and the control's, each beside its limit, and the
verdict a run gives each (``correct``, ``control_correct``: every number
within its limit); the control has to come out not correct.  The
benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(run.ROOT, args.workload, seed, args.seconds, False,
                           control=True)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "control_correct": run.within(res["control"]),
                          "program": res["checks"], "control": res["control"]}),
              flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
