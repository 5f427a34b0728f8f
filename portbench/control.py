"""The control of a cell's check: the plain reference put in the program's
place, one precision below the configuration's (``limits/<cell>.json``
``control``: ``int4`` for int8 codes, ``tf32`` for f32 rows), judged by
the same numbers as a run. It has to come out not correct.

    python -m portbench.control --workload <cell> --seeds <n> [<n> ...]

For each seed: the cell's rows and query pool, a seeded uniform sample of
the mix's ``check_answers`` pool queries (as many answers as a run
checks), the control's top-k of each, and one JSON line of the numbers
with ``fails`` (the compared numbers over their limits). Needs a CUDA
device, as the cell does; ``--device cpu`` runs it on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from portbench import data, judge, reference, spec


def control_numbers(workload: str, seed: int, device: str,
                    repo: str = spec.REPO) -> dict:
    bench = spec.benchmark(repo)
    cell = spec.workload(bench, workload)
    config = spec.config(bench, cell, repo)
    traffic = spec.traffic(cell["traffic"], repo)
    limits = spec.limits(workload, repo)
    k = int(traffic["k"])
    rows, pool = data.make_rows(dict(config["data"], pool=config["query_pool"]),
                                config["rows"], config["dim"], seed, device)
    rng = np.random.default_rng([seed % (1 << 63), 7])
    pidx = rng.integers(0, pool.shape[0], int(traffic["check_answers"]))
    uq, inv = np.unique(pidx, return_inverse=True)
    keep = judge.allowed_rows(rows.shape[0], traffic.get("filter"))
    scan_rows = rows if keep is None else rows[keep]
    scores, ids = reference.control_topk(limits["control"], pool[uq], scan_rows, k,
                                         config["metric"], device)
    if keep is not None:
        ids = keep[ids]
    sample = {"pool": pidx, "count": np.full(len(pidx), k, np.int32),
              "ids": ids[inv], "scores": scores[inv]}
    found = judge.numbers(sample, pool, rows, k, config["metric"], device,
                          traffic.get("filter"))
    fails = [n for n, lim in limits["compare"].items()
             if found.get(n) is not None and found[n] > lim["limit"]]
    return {"workload": workload, "seed": seed, "control": limits["control"],
            **found, "fails": fails}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("control: no CUDA device", file=sys.stderr)
            return 2
    for seed in args.seeds:
        t = time.monotonic()
        out = control_numbers(args.workload, seed, args.device)
        out["seconds"] = time.monotonic() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
