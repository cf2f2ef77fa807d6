"""Readings of the k-means check on the card, over many seeds, without a
window.

    python3 bench/quantizer.py --config <name> --seeds a,b,c [--kmeans-iters n]

For each seed: the configuration's corpus drawn as a run draws it, the
program's ``IVFIndex.train`` over its training rows, and the reference's
``kmeans_excess`` of the centroids it made, beside the configuration's
limit.  ``--kmeans-iters`` runs the program with that many Lloyd
iterations in place of the configuration's (0: centroids left at their
init), a fault the check has to catch; the reference keeps the
configuration's.  Prints one JSON line a seed.  The benchmark's own runs
do not run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import gen, reference  # noqa: E402


def main(argv=None) -> int:
    from repro_torch.core.ivf import IVFIndex, IVFIndexConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--kmeans-iters", type=int, default=None)
    args = ap.parse_args(argv)
    cfg = json.loads((ROOT / "bench" / "configs" / f"{args.config}.json").read_text())
    idx = cfg["index"]
    program = dict(idx)
    if args.kmeans_iters is not None:
        program["kmeans_iters"] = args.kmeans_iters
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        corpus, _ = gen.draw(cfg["corpus"], cfg["n_rows"], cfg["dim"], seed,
                             gen.STREAM_CORPUS, dev)
        x = corpus[: cfg["train_rows"]]
        t = time.perf_counter()
        index = IVFIndex(IVFIndexConfig(**program), device=dev)
        index.train(x)
        cents = index.state.centroids.detach().clone()
        del index
        gc.collect()
        torch.cuda.empty_cache()
        t_train = time.perf_counter() - t
        t = time.perf_counter()
        excess = reference.kmeans_excess(x, cents, idx["kmeans_iters"], idx["seed"])
        print(json.dumps({
            "seed": seed, "program_iters": program["kmeans_iters"],
            "kmeans_excess": excess, "limit": cfg["limits"]["kmeans_excess"],
            "train_s": t_train, "reference_s": time.perf_counter() - t}), flush=True)
        del corpus, x, cents
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
