"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Without a CUDA device, or with fewer than the cell asks for, it exits 2
and prints no result; so it does where the program (``coltt_tpu_torch``)
is not there. The last line of standard output is one JSON object; the
last lines of standard error are the numbers of the check, each beside
its limit. Nothing heavy is imported at module level: the client
processes, spawned, import this module again.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(REPO, ".portbench_cache")


def main(argv=None) -> int:
    t_start = time.monotonic()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ["USE_FLAX"] = "0"

    from portbench import spec

    cell = spec.workload(spec.benchmark(REPO), args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s), "
              f"found {have}; no result", file=sys.stderr)
        return 2

    from portbench import harness

    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=t_start, repo=REPO)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for name, c in result["checked"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
