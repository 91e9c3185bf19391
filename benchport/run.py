"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 benchport/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic (files named in BENCHMARK.json),
sets up the port's engines, warms every shape on every stream, measures a
closed loop for ``--seconds``, checks a sample of the window's answers
against the plain reference, and prints one JSON line last on standard
output: the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics read from spans and a torch.profiler trace.  Earlier lines give the
seconds of each set-up phase, the window's batches and the check.  Without a
CUDA device, or with fewer than the cell asks for, it exits 2 and prints no
result.  ``--control 1`` puts the reference's control (one guarantee of the
configuration broken) in the program's place for the compared answers: its
run must come out not correct.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    try:
        from benchport import harness
    except ImportError as e:
        print(f"benchport: {e}", file=sys.stderr)
        return 2
    try:
        return harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T0,
                           control=bool(args.control))
    except (harness.RunError, ImportError) as e:
        print(f"benchport: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
