"""Run one cell of ``BENCHMARK.json`` once: set up, measure for a fixed
number of seconds, check the outputs against the plain reference, print
one JSON line.

Every piece is found by its name, so that a new cell, configuration,
traffic mix or metric is new files and entries only:

- the cell ``<config>.<traffic>`` in ``BENCHMARK.json``'s ``workloads``;
- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the mix's parameters and its ``driver``;
- ``drivers/<driver>.py``: ``TRAFFIC`` (the mix's keys it reads, with the
  values it supports; a mix with another key or value is refused, as is
  a configuration whose value of a key in ``CONFIG`` it does not
  support), ``setup(ctx) -> state``, ``unit(state, i)``
  (one request, step or call of the window), ``drain(state)`` (wait for
  the device) and ``check(state) -> {name: value}`` (frees the program's
  state, then works out with the reference the numbers that decide
  ``correct``);
- ``metrics/<metric>.py``: ``read(run) -> float | None`` for each
  end-to-end and per-layer metric (``Run`` below); None leaves the metric
  out of the line.  A metric ``<name>.<part>`` without a file of its own
  is read by ``metrics/<name>.py``;
- ``limits/<cell>.json``: the limit of each number ``check`` returns.

A run: the setup (``setup_s`` counts from the process's start to the
window's first unit), then units back to back for ``--seconds`` of the
host's clock, then the device drained.  With ``--trace 1`` the profiler
records the last ``TRACE_SECONDS`` of the window (and the drain); the
per-layer metrics read that slice.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msda_tpu")
#: the traced slice at the end of a ``--trace 1`` window, seconds
TRACE_SECONDS = 2.0
PROGRAM = "msda_tpu_torch"
#: keys of a traffic mix that describe it; no driver reads them
TRAFFIC_NOTES = ("driver", "why", "source")


class Refused(Exception):
    """The run cannot be made here; nothing is printed on stdout."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The Python file ``path``, loaded by its path (names may hold dots)."""
    if not path.is_file():
        raise Refused(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(
        "perfbench._" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The entries of ``bench[kind]`` that ``cell`` reports: those that
    list it, and those without a list; a per-layer metric without a list
    is reported where the end-to-end metric it moves is."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def unsupported(config: dict, traffic: dict, driver) -> list[str]:
    """What of the configuration and the mix ``driver`` would not honour:
    a key of the mix it does not read, or a value it does not support
    (its ``TRAFFIC`` and ``CONFIG``)."""
    out = []
    for where, data, reads, strict in (
            ("traffic", traffic, getattr(driver, "TRAFFIC", {}), True),
            ("configuration", config, getattr(driver, "CONFIG", {}), False)):
        for key, value in data.items():
            if key in reads:
                if reads[key] is not None and value not in reads[key]:
                    out.append(f"{where} {key}={value!r} (supported: "
                               f"{', '.join(map(repr, reads[key]))})")
            elif strict and key not in TRAFFIC_NOTES:
                out.append(f"{where} key {key!r} (not read)")
    return out


def reader(here: Path, metric: str):
    """``metrics/<metric>.py``, or for ``<name>.<part>`` without a file of
    its own, ``metrics/<name>.py``."""
    path = here / "metrics" / f"{metric}.py"
    if not path.is_file() and "." in metric:
        path = here / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    return load_module(path)


def find_cell(root: Path, name: str) -> SimpleNamespace:
    """The cell ``name`` with its configuration, traffic, limits, driver
    and metric readers, all found by name."""
    bench = load_json(root / "BENCHMARK.json")
    here = root / "perfbench"
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json "
                      f"(there are {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(here / "traffic" / f"{w['traffic']}.json")
    limits = load_json(here / "limits" / f"{name}.json")
    driver = load_module(here / "drivers" / f"{traffic['driver']}.py")
    refused = unsupported(config, traffic, driver)
    if refused:
        raise Refused(f"the {traffic['driver']} driver of {name} does not "
                      "support: " + "; ".join(refused))
    e2e = cell_metrics(bench, name, "end_to_end")
    layer = cell_metrics(bench, name, "per_layer")
    readers = {m["name"]: reader(here, m["name"]) for m in e2e + layer}
    return SimpleNamespace(name=name, chips=w["chips"], config=config,
                           traffic=traffic, limits=limits, driver=driver,
                           e2e=e2e, per_layer=layer, readers=readers)


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def process_age_s() -> float:
    """Seconds since this process started (Linux's ``/proc``), or 0."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


class Run:
    """What the metric readers read: ``state`` (the driver's), the
    configuration and traffic, ``setup_s``, ``window_s`` and ``units``
    (the whole window), and, in a traced run, ``trace`` (a
    ``tracefile.TraceFile`` of the slice), ``traced_s`` (its length on the
    host's clock), ``traced`` (the range of units in it) and ``launches``
    (the program's kernel launches in it, by kernel)."""

    def __init__(self, cell, state):
        self.state = state
        self.config, self.traffic = cell.config, cell.traffic
        self.setup_s = self.window_s = None
        self.units = 0
        self.trace = self.traced_s = None
        self.traced = range(0)
        self.launches = {}
        self.window_peak_bytes = 0


def _launch_counts() -> dict:
    from msda_tpu_torch.ops import launches
    return launches.counts()


def _profiler():
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def warm_profiler(sync) -> None:
    """Start and stop the profiler once, so that its start in the window
    (the first loads and initialises CUPTI) takes no time there."""
    profiler = _profiler()
    profiler.start()
    sync()
    profiler.stop()


def measure(cell, state, seconds: float, trace: bool, tmpdir: str, sync):
    """The window: units back to back until ``seconds`` have passed on the
    host's clock, and with ``trace`` until the profiler has recorded
    ``TRACE_SECONDS`` of them (it starts ``TRACE_SECONDS`` before the
    end), then the device drained.  Returns the ``Run``."""
    import torch

    run = Run(cell, state)
    trace_from = max(0.0, seconds - TRACE_SECONDS) if trace else math.inf
    profiler = None
    end = seconds
    sync()
    # no collector pass inside the window: the drivers keep every answer
    # until the check, and a pass over them would stall a unit
    gc.collect()
    gc.disable()
    t0 = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter() - t0
        if now >= end:
            break
        if profiler is None and now >= trace_from:
            # the device's queue drained first: the profiler records only
            # what is launched after it starts
            sync()
            profiler = _profiler()
            profiler.start()
            traced_from, launched = i, _launch_counts()
            t_trace = time.perf_counter()
            end = max(seconds, t_trace - t0 + TRACE_SECONDS)
        with torch.profiler.record_function("perfbench.unit"):
            cell.driver.unit(state, i)
        i += 1
    with torch.profiler.record_function("perfbench.drain"):
        cell.driver.drain(state)
    t1 = time.perf_counter()
    gc.enable()
    run.window_s, run.units = t1 - t0, i
    if profiler is not None:
        run.traced_s = t1 - t_trace
        profiler.stop()
        path = os.path.join(tmpdir, "trace.json")
        profiler.export_chrome_trace(path)
        from .tracefile import TraceFile
        run.trace = TraceFile(path)
        os.unlink(path)
        run.traced = range(traced_from, i)
        after = _launch_counts()
        run.launches = {k: n - launched.get(k, 0) for k, n in after.items()}
    return run


def execute(cell, seed: int, seconds: float, trace: bool, device,
            started: float, tmpdir: str, phases=()) -> dict:
    """Set up, measure, read the metrics, check: the result line's
    fields, with ``checks`` last (each number compared and its limit);
    ``failed`` counts the numbers over their limit."""
    import torch

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    phases = [*phases, ("the cell's files", time.perf_counter())]

    def mark(name):
        """Close the set-up phase ``name`` (printed on stderr)."""
        sync()
        phases.append((name, time.perf_counter()))

    ctx = SimpleNamespace(name=cell.name, config=cell.config,
                          traffic=cell.traffic, seed=seed, device=device,
                          trace=trace, tmpdir=tmpdir, mark=mark)
    state = cell.driver.setup(ctx)
    if trace:
        warm_profiler(sync)
    sync()
    # reserved, not allocated: a CUDA graph's replay allocates nothing, so
    # the allocated peak would miss the memory its pool holds
    setup_peak = torch.cuda.max_memory_reserved(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - started
    last = started
    for name, t in phases:
        print(f"setup {name}: {t - last:.3f} s", file=sys.stderr)
        last = t
    run = measure(cell, state, seconds, trace, tmpdir, sync)
    run.setup_s = setup_s
    run.window_peak_bytes = (torch.cuda.max_memory_reserved(device)
                             if cuda else 0)

    metrics = {}
    for m in (cell.per_layer if trace else cell.e2e):
        value = cell.readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"attempted": run.units, "metrics": metrics}
    result["device"] = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": cell.chips,
        "memory_peak_bytes": max(setup_peak, run.window_peak_bytes),
    }
    if trace:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.traced_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
        run.trace = None

    readings = cell.driver.check(state)
    del state, run
    checks, failed = {}, 0
    for name, limit in cell.limits.items():
        value = float(readings.pop(name, math.nan))
        ok = value <= limit  # a missing or NaN reading fails
        failed += not ok
        checks[name] = {"value": value, "limit": limit}
    for name, value in readings.items():  # numbers without a limit fail
        checks[name] = {"value": float(value), "limit": None}
        failed += 1
    result["correct"] = failed == 0
    result["failed"] = failed
    result["checks"] = checks
    return result


def parse(argv):
    p = argparse.ArgumentParser(
        prog="perfbench/run.py",
        description="Run one cell of BENCHMARK.json and print one JSON line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def program_in(root: Path) -> None:
    """Refuse unless the program is imported from the checkout ``root``."""
    import msda_tpu_torch

    where = Path(msda_tpu_torch.__file__).resolve()
    if root not in where.parents:
        raise Refused(f"{PROGRAM} was imported from {where}, outside {root}")


def main(argv, started: float, root: Path = ROOT, device=None) -> int:
    """The command: 0 and one JSON line on stdout, or another code and no
    line.  ``device`` (tests) skips the look for a card."""
    args = parse(argv)
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "extensions")
    os.environ["USE_FLAX"] = "0"
    phases = [("python", time.perf_counter())]
    try:
        import torch

        phases.append(("import torch", time.perf_counter()))
        # one host thread for PyTorch's own CPU work: no idle pool
        # spinning beside the thread that launches the device's work
        torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cell = find_cell(root, args.workload)
        if device is None:
            if not torch.cuda.is_available():
                raise Refused("no CUDA device: torch.cuda.is_available() is "
                              "false")
            if torch.cuda.device_count() < cell.chips:
                raise Refused(f"{args.workload} needs {cell.chips} cards, "
                              f"{torch.cuda.device_count()} present")
            device = torch.device("cuda", 0)
            torch.cuda.set_device(device)
            torch.empty(1, device=device)
            phases.append(("the CUDA context", time.perf_counter()))
        program_in(root)
        phases.append((f"import {PROGRAM}", time.perf_counter()))
        with tempfile.TemporaryDirectory(prefix="perfbench-") as tmpdir:
            result = execute(cell, args.seed, args.seconds, bool(args.trace),
                             device, started, tmpdir, phases)
    except Refused as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print("perfbench: refused, these modules are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        verdict = "ok" if c["limit"] is not None and c["value"] <= c["limit"] \
            else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
