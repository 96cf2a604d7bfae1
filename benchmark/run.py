"""Run one cell of the benchmark of ``clipx_torch`` once, on the card.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up (inputs and weights from the seed, the
program built and warmed for this cell's shapes), then the measured window,
then the check against the plain reference. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; ``checks`` comes last, each compared number beside its
limit, and the same lines end standard error. Exits non-zero, printing no
result, without enough CUDA devices, without the program, or when the
process holds a module of JAX or of the JAX package.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

def process_age() -> float:
    """Seconds since this process started (the kernel's start time), or
    since this module's first line where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _STARTED


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = time.perf_counter() - process_age()

    import torch

    from benchmark import harness

    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}; one of {sorted(cells)}",
              file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        out, notes = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace),
                               device=torch.device("cuda", 0),
                               started=started)
    except Exception:  # noqa: BLE001 — report, print no result
        traceback.print_exc()
        return 1
    bad = harness.forbidden_modules(list(sys.modules))
    if bad:
        print("the run loaded JAX or the JAX package: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    notes["card"] = harness.power_limit()
    harness.print_result(out, notes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
