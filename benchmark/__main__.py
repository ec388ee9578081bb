"""python -m benchmark --workload NAME --seed N --seconds S --trace 0|1

One run of one cell of BENCHMARK.json on the card; the last line of
standard output is the result's JSON object, and the last lines of
standard error are the numbers compared, each beside its limit.
``--control 1`` also judges the control (the reference one precision
below the configuration's) on the same inputs and prints its numbers.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # every cache of a run inside the checkout, at fixed paths; no library
    # that the port uses may load JAX on its own
    cache = ROOT / ".bench_torch_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("benchmark: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from .harness import forbidden_modules, run_cell

    line, checks, control = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                     device="cuda", t_process=T_PROCESS,
                                     control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    if control is not None:
        line["control"] = {n: {"value": v, "limit": lim} for n, v, lim in control}
        line["checks"] = line.pop("checks")  # the numbers compared stay last
        for n, v, lim in control:
            print(f"control {n} {v!r} (limit {lim!r})", file=sys.stderr)
    try:
        io = dict(x.split(": ") for x in Path("/proc/self/io").read_text().splitlines())
        print(f"benchmark: the process wrote {int(io['write_bytes']) / 2**30:.3f} GiB to storage "
              f"({int(io['wchar']) / 2**30:.3f} GiB through write calls)", file=sys.stderr)
    except (OSError, KeyError, ValueError):
        pass
    for n, v, lim in checks:
        print(f"check {n} {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


sys.exit(main())
