"""The harness: finds a cell's configuration, traffic, driver, limits and
metric readers by name, runs set-up, the window and the check, and builds
the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own under ``benchmark/``, found by its name in
``BENCHMARK.json``:

- ``configs/<config>.json``: the configuration's sizes, as run;
- ``traffic/<traffic>.json``: ``driver`` (a file of ``drivers/``) and the
  parameters it reads;
- ``drivers/<driver>.py``: ``setup``, ``window``, ``release`` and
  ``check`` (see ``drivers/encode_stream.py``);
- ``limits/<workload>.json``: the limit of each number ``check`` compares;
- ``metrics/<metric>.py``: ``read(run)``, a per-layer metric from the
  run's spans, counters and device trace, or None where there is nothing
  to read.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# whole top-level module names a run may not hold (``clipx`` is the JAX
# package; the port's ``clipx_torch`` is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "clipx")


def forbidden_modules(modules) -> List[str]:
    """The names in ``modules`` whose top-level name is forbidden, compared
    whole: ``clipx_torch`` is not ``clipx``."""
    return sorted(n for n in modules if n.split(".")[0] in FORBIDDEN)


def load_json(root: str, *parts: str) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def load_module(root: str, kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (the names may hold dots)."""
    path = os.path.join(root, "benchmark", kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reading(readings: dict, name: str):
    """A driver's reading of an end-to-end metric: ``<base>.<cell>`` (one
    quantity split by cell, each with its own bound) reads ``<base>``."""
    if name in readings:
        return readings[name]
    return readings.get(name.split(".")[0])


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Run:
    """What a driver and the metric readers share about one run. Times are
    ``time.perf_counter`` seconds from the window's start."""

    workload: str
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    device: Any
    t0: float = 0.0
    # the program's own int8 path (the control of the index cells)
    compute_quant: Optional[str] = None
    # set by the driver
    attempted: int = 0
    failed: int = 0
    e2e: Dict[str, float] = field(default_factory=dict)
    spans: List[tuple] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)
    notes: Dict[str, Any] = field(default_factory=dict)
    # what the check and the readers need, not printed
    data: Dict[str, Any] = field(default_factory=dict)
    # set by the harness
    launches: Dict[str, int] = field(default_factory=dict)
    trace: Optional[Any] = None

    def span(self, name: str, start: float, end: float) -> None:
        self.spans.append((name, start - self.t0, end - self.t0))

    @contextlib.contextmanager
    def stage(self, name: str):
        """Times one step of set-up into ``notes["setup_stages"]``."""
        t = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                import torch

                torch.cuda.synchronize(self.device)
            self.notes.setdefault("setup_stages", {})[name] = (
                time.perf_counter() - t)


def _launch_counts() -> Dict[str, int]:
    from clipx_torch.ops._launch import launch_counts

    return launch_counts()


def _memory_peak(device) -> Optional[int]:
    import torch

    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device, started: float, root: str = ROOT,
             compute_quant: Optional[str] = None) -> dict:
    """One run of one cell: (the result line's object, notes for standard
    error). ``started`` is the ``time.perf_counter`` reading taken as the
    process's start; ``compute_quant`` is for the control alone."""
    bench = load_json(root, "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    config = load_json(root, "benchmark", "configs", cell["config"] + ".json")
    traffic = load_json(root, "benchmark", "traffic",
                        cell["traffic"] + ".json")
    limits = load_json(root, "benchmark", "limits", workload + ".json")
    driver = load_module(root, "drivers", traffic["driver"])
    per_layer = [m for m in bench["per_layer"] if applies(m, workload)]
    readers = {m["name"]: load_module(root, "metrics", m["name"])
               for m in per_layer} if trace else {}
    run = Run(workload, cell, config, traffic, limits, seed, seconds, device,
              compute_quant=compute_quant)
    e2e = [m for m in bench["end_to_end"] if applies(m, workload)]
    with _environment(traffic.get("env", {})):
        return _run(run, driver, e2e, per_layer, readers, trace, started)


@contextlib.contextmanager
def _environment(env: dict):
    """The traffic's ``env`` set for the program, and put back after."""
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update({key: str(val) for key, val in env.items()})
    try:
        yield
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


def _run(run, driver, e2e, per_layer, readers, trace, started):
    """Set-up, the window, the check and the result line of one run."""
    import torch

    device = run.device
    cuda = device.type == "cuda"
    run.notes["setup_stages"] = {"process_start": time.perf_counter()
                                 - started}
    state = driver.setup(run)
    if trace and cuda:
        from benchmark.trace import warm_profiler

        with run.stage("profiler"):
            warm_profiler()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    before = _launch_counts()
    run.t0 = time.perf_counter()
    setup_s = run.t0 - started
    if trace and cuda:
        from benchmark.trace import Trace

        run.trace = Trace(run.t0)
    driver.window(run, state)
    if run.trace is not None:
        run.trace.stop()
    elif cuda:
        torch.cuda.synchronize(device)
    after = _launch_counts()
    run.launches = {k: after[k] - before.get(k, 0) for k in after}
    # the kernels the window launched, by wrapper (``ops/_launch.py``)
    run.notes["launches"] = {k: n for k, n in run.launches.items() if n}
    peak = _memory_peak(device)
    driver.release(run, state)
    del state
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = driver.check(run)
    run.notes["check_s"] = time.perf_counter() - t

    metrics = {}
    if trace:
        for m in per_layer:
            value = readers[m["name"]].read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        readings = dict(run.e2e, setup_s=setup_s)
        for m in e2e:
            value = reading(readings, m["name"])
            if value is None:
                raise RuntimeError(f"driver {run.traffic['driver']} measured no "
                                   f"{m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": (torch.cuda.get_device_name(device) if cuda
                    else device.type),
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown(run.spans)
    out["checks"] = checks
    return out, run.notes


def check_lines(checks: dict) -> List[str]:
    return [f"check {name} {c['value']!r} limit {c['limit']!r}"
            for name, c in checks.items()]


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def print_result(out: dict, notes: dict) -> None:
    """``notes`` (set-up stages, counts, the card) on standard error, then
    the check lines; the result line last on standard output."""
    print("notes " + json.dumps(notes), file=sys.stderr)
    for line in check_lines(out["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
