"""The run of one cell: find it by name, check the card, set the caches, run
the traffic's kind, judge the result, print the line.

A cell names a configuration and a traffic mix in ``BENCHMARK.json``; a
configuration is a file of its own (its ``file``), a traffic mix is
``benchmark/traffic/<name>.json`` and names its ``kind``, the module of
``benchmark/kinds`` that drives it, and a per-layer metric is
``benchmark/metrics/<name>.py`` with a ``read(data)`` function.  Nothing
here names a cell, a configuration or a metric.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax",
                     "photorealistic_rendering_using_opencl_tpu")


class NoCard(RuntimeError):
    """The run asks for more cards than the machine has."""


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def find_cell(spec: dict, root: str, workload: str) -> dict:
    """The cell ``workload`` with its configuration and traffic read."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    entry = configs[cell["config"]]
    with open(os.path.join(root, entry["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(root, "benchmark", "traffic",
                           cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    return {"cell": cell, "config_entry": entry, "config": config,
            "traffic": traffic}


def metrics_for(spec: dict, workload: str, trace: bool) -> list:
    """The metric entries this cell reports: the end-to-end ones without a
    trace, the per-layer ones with."""
    if not trace:
        return [m for m in spec["end_to_end"]
                if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in metrics_for(spec, workload, False)}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def load_reader(name: str, root: str):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    mod_name = "benchmark_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_kind(kind: str):
    return importlib.import_module(f"benchmark.kinds.{kind}")


def set_caches(root: str) -> None:
    """The run's environment, set before torch is imported: every build
    and kernel cache at a fixed path inside the checkout, few threads."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")
    # one process with few threads: the host's CPU-side thread pools, which
    # the card's path does not use, kept from contending with its launches
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def require_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: the benchmark measures the card and "
                     "never falls back to the CPU")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell asks for {n} cards, the machine has "
                     f"{torch.cuda.device_count()}")


def process_clock(t_import: float):
    """A clock of the seconds since this process started: /proc's start
    time where it can be read, else since ``t_import`` (a perf_counter
    reading taken first thing)."""
    def by_proc():
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start

    try:
        offset = by_proc() - (time.perf_counter() - t_import)
        if not 0.0 <= offset < 60.0:
            offset = 0.0
    except (OSError, ValueError, IndexError):
        offset = 0.0
    return lambda: time.perf_counter() - t_import + offset


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name is a JAX one, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def card_info() -> dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip().splitlines()
        info["power_limit"] = out[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        info["power_limit"] = "not read"
    return info


def card_state(device) -> str | None:
    """The card's SM clock, temperature, power draw and active clock
    throttle reasons as ``nvidia-smi`` reads them (None on the CPU, or
    where it cannot be read): printed beside each window, so that a run
    slowed by its card shows why."""
    if device.type != "cuda":
        return None
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,"
             "power.draw,clocks_throttle_reasons.active",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown: dict | None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(root: str, workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", since_start=time.perf_counter) -> dict:
    """Drive one run of a cell -> the result dict (not yet printed).
    ``device="cpu"`` is for the CPU tests only: the command line always
    asks for the card.  ``since_start()`` reads the seconds since the
    process started; the kind reads it when its window opens, for
    ``setup_s``."""
    spec = load_spec(root)
    found = find_cell(spec, root, workload)
    kind = load_kind(found["traffic"]["kind"])
    want = metrics_for(spec, workload, trace)
    res = kind.run(found, seed=seed, seconds=seconds, trace=trace,
                   device=device, since_start=since_start)
    metrics = {}
    for m in want:
        if trace:
            value = load_reader(m["name"], root)(res["layer"])
        else:
            value = res["metrics_e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    res["metrics"] = metrics
    return res


def main(argv=None, t_import: float | None = None) -> int:
    clock = process_clock(time.perf_counter() if t_import is None
                          else t_import)
    args = parse_args(argv)
    root = os.getcwd()
    set_caches(root)
    try:
        spec = load_spec(root)
        cell = {w["name"]: w for w in spec["workloads"]}[args.workload]
        require_cards(int(cell["chips"]))
    except NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    res = run(root, args.workload, args.seed, args.seconds, bool(args.trace),
              since_start=clock)
    found = forbidden_loaded()
    if found:
        print(f"benchmark: JAX modules loaded: {found}", file=sys.stderr)
        return 3
    device = card_info()
    device.update(count=int(cell["chips"]),
                  memory_peak_bytes=int(res["memory_peak_bytes"]))
    if args.trace:
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(result_line(res["correct"], res["attempted"], res["failed"],
                      res["metrics"], device, res["checks"],
                      res.get("breakdown") if args.trace else None))
    sys.stdout.flush()
    return 0
