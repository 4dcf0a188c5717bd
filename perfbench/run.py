"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the cell's cards.  The
last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last: each number compared beside its
limit, which also end standard error).  Exits 2, printing no result,
without enough CUDA cards, and 3 if JAX or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()            # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    build = CHECKOUT / "build"
    # every kernel cache of the program at a fixed path in the checkout
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    here = CHECKOUT / "perfbench"
    sys.path[:] = [str(CHECKOUT / "src"), str(CHECKOUT)] + [
        p for p in sys.path if Path(p or ".").resolve() != here]
    from perfbench.harness import cell as C
    from perfbench.harness.guard import forbidden_loaded
    from perfbench.harness.runner import execute, log

    cell = C.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}")
        return 2
    result = execute(cell, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device="cuda", t0=T0)
    found = forbidden_loaded()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
