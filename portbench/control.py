"""The controls of a cell's check: the plain reference put in the
program's place in a way that has to come out not correct, judged by the
same numbers as a run. ``limits/<cell>.json`` ``control`` names one or a
list of them (``reference.CONTROLS``): ``int4`` (int4 codes for int8
ones) or ``tf32`` (TF32 operands for f32 rows), one precision below the
configuration's, and ``drop10``, the exact scan of the rows less a
seeded tenth of them.

    python -m portbench.control --workload <cell> --seeds <n> [<n> ...] [--control <name>]

For each seed and control (every control of the cell, or the one named):
the cell's rows and query pool, a seeded uniform sample of the mix's
``check_answers`` pool queries (as many answers as a run checks), the
control's top-k of each, and one JSON line of the numbers with ``fails``
(the compared numbers over their limits) and the ``seconds`` the
control and its judgement took. Needs a CUDA device, as the
cell does; ``--device cpu`` runs it on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from portbench import data, judge, reference, spec


def controls(limits: dict) -> list:
    """A limits file's ``control``: one name or a list of them."""
    c = limits["control"]
    return [c] if isinstance(c, str) else list(c)


def control_numbers(workload: str, seed: int, device: str,
                    repo: str = spec.REPO, only: str | None = None) -> list:
    """One dict of numbers, with ``fails``, for each control of the cell
    (or the one named ``only``) on ``seed``."""
    bench = spec.benchmark(repo)
    cell = spec.workload(bench, workload)
    config = spec.config(bench, cell, repo)
    traffic = spec.traffic(cell["traffic"], repo)
    limits = spec.limits(workload, repo)
    names = controls(limits) if only is None else [only]
    k = int(traffic["k"])
    rows, pool = data.make_rows(dict(config["data"], pool=config["query_pool"]),
                                config["rows"], config["dim"], seed, device)
    rng = np.random.default_rng([seed % (1 << 63), 7])
    pidx = rng.integers(0, pool.shape[0], int(traffic["check_answers"]))
    uq, inv = np.unique(pidx, return_inverse=True)
    keep = judge.allowed_rows(rows.shape[0], traffic.get("filter"))
    scan_rows = rows if keep is None else rows[keep]
    out = []
    for name in names:
        t = time.monotonic()
        scores, ids = reference.control_topk(name, pool[uq], scan_rows, k,
                                             config["metric"], device, seed)
        if keep is not None:
            ids = keep[ids]
        sample = {"pool": pidx, "count": np.full(len(pidx), k, np.int32),
                  "ids": ids[inv], "scores": scores[inv]}
        found = judge.numbers(sample, pool, rows, k, config["metric"], device,
                              traffic.get("filter"))
        fails = [n for n, lim in limits["compare"].items()
                 if found.get(n) is not None and found[n] > lim["limit"]]
        out.append({"workload": workload, "seed": seed, "control": name,
                    **found, "fails": fails, "seconds": time.monotonic() - t})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--control", choices=reference.CONTROLS,
                    help="run this control alone (default: every control of the cell)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("control: no CUDA device", file=sys.stderr)
            return 2
    for seed in args.seeds:
        for out in control_numbers(args.workload, seed, args.device,
                                   only=args.control):
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
