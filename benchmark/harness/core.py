"""What every cell shares: finding a cell's files by name, the guards a run
must pass, the run's record and its result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
configuration's ``file`` is the resolved recipe; the mix is
``traffic/<traffic>.json``, whose ``driver`` names the loop in
``drivers/<driver>.py`` that runs it; each metric is read by
``metrics/<name>.py``; the limits of the cell's correctness check are
``limits/<workload>.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# top-level module names no run may hold: the JAX stack and the JAX package
# (compared whole: ``ponderv2_tpu_torch`` is not ``ponderv2_tpu``), and the
# repository's TPU-era scripts when they are loaded from the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ponderv2_tpu")
FORBIDDEN_SCRIPTS = ("bench", "chip_smoke", "tools")


class WindowClosed(Exception):
    """Raised from inside the program's loop when the measured window ends."""


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str, bench: Optional[Dict] = None) -> Dict:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(name: str, bench: Optional[Dict] = None) -> Dict:
    bench = bench or benchmark()
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def mix(traffic: str) -> Dict:
    return load_json(os.path.join(BENCH_DIR, "traffic", f"{traffic}.json"))


def limits(workload: str) -> Dict[str, float]:
    """The cell's limits ({} for a cell that has none yet: it is not correct)."""
    path = os.path.join(BENCH_DIR, "limits", f"{workload}.json")
    return load_json(path)["limits"] if os.path.isfile(path) else {}


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def metric_reader(name: str):
    return load_file(os.path.join(BENCH_DIR, "metrics", f"{name}.py"),
                     "benchmark_metric_" + name.replace(".", "_").replace("-", "_"))


def cell_metrics(bench: Dict, workload: str, section: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
    that list it, and those with no ``workloads`` key."""
    return [m for m in bench[section]
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> List[str]:
    """Loaded modules no run may hold, by whole top-level name."""
    found = set()
    for name, mod in list(sys.modules.items()):
        top = name.split(".", 1)[0]
        if top in FORBIDDEN:
            found.add(top)
        elif top in FORBIDDEN_SCRIPTS:
            path = os.path.abspath(getattr(mod, "__file__", None) or "")
            if path.startswith(ROOT + os.sep):
                found.add(top)
    return sorted(found)


def set_cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout. The port builds
    its CUDA sources into ``ponderv2_tpu_torch/csrc/_build/`` itself."""
    base = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["USE_FLAX"] = "0"


class Check:
    """The numbers compared with the plain reference, each with its limit;
    a number above its limit (or not finite) makes the run not correct."""

    def __init__(self, limits: Dict[str, float]):
        self.limits = dict(limits)
        self.values: Dict[str, float] = {}

    def add(self, name: str, value: float) -> None:
        self.values[name] = float(value)

    @property
    def correct(self) -> bool:
        if not self.limits or set(self.values) != set(self.limits):
            return False
        return all(v == v and v <= self.limits[k] for k, v in self.values.items())

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"value": self.values.get(k, float("nan")), "limit": lim}
                for k, lim in self.limits.items()}

    def lines(self) -> List[str]:
        return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
                for k, v in self.report().items()]


class Run:
    """What one run of a cell records for the metric readers.

    ``count`` units (steps or fragments) finished in the window of
    ``window_s`` seconds; ``setup`` the set-up's seconds by phase, of which
    ``benchmark_s`` the benchmark's own work, left out of ``setup_s``;
    ``host`` lists of host seconds by span name over the window; with
    ``--trace 1``, ``trace`` (``harness.trace.Timeline``) and ``work``, the
    traced units' work and band-conv calls (``harness.trace.Work``)."""

    def __init__(self, workload: str, kind: str, t0: float):
        self.workload, self.kind = workload, kind
        self.setup: Dict[str, float] = {}
        self.benchmark_s = 0.0
        self._mark = t0
        self.setup_s = 0.0
        self.window_s = 0.0
        self.count = 0
        self.attempted = 0
        self.failed = 0
        self.unit_s: List[float] = []
        self.host: Dict[str, List[float]] = {}
        self.peak_bytes = 0
        self.check_s = 0.0  # the correctness check's seconds, after the window
        self.trace = None
        self.work = None

    def span(self, name: str, seconds: float) -> None:
        self.host.setdefault(name, []).append(seconds)

    def phase(self, name: str, benchmark: bool = False) -> None:
        """Ends a phase of the set-up, begun where the last one ended (the
        first at the process's start)."""
        import time

        now = time.perf_counter()
        self.setup[name] = now - self._mark
        self._mark = now
        if benchmark:
            self.benchmark_s += self.setup[name]


class Ctx:
    """One run of one cell: the cell's entries and files, the run's seed,
    window and trace flag, its device and scratch directory. ``options``
    are further config overrides (the tests' small sizes); ``controls``
    the reference precisions also read in place of the program (the
    calibration's control runs)."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", tmp: Optional[str] = None,
                 bench: Optional[Dict] = None, mix_overrides: Optional[Dict] = None,
                 options: Optional[Dict] = None, controls=(), t0: Optional[float] = None):
        import time

        self.bench = bench or benchmark()
        self.workload = workload
        self.cell = cell(workload, self.bench)
        self.config = config_entry(self.cell["config"], self.bench)
        self.config_file = os.path.join(ROOT, self.config["file"])
        self.mix = {**mix(self.cell["traffic"]), **(mix_overrides or {})}
        self.limits = limits(workload)
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = device
        self.tmp = tmp
        self.options = dict(options or {})
        self.controls = tuple(controls)
        self.t0 = time.perf_counter() if t0 is None else t0
        # the seed as the program's own seeding takes it (numpy: 32 bits)
        self.program_seed = self.seed % 2 ** 31

    def parse_config(self, options: Dict):
        """The program's config parser over the frozen recipe with the run's
        overrides (and the program's seeding of python, numpy and torch)."""
        from ponderv2_tpu_torch.engines.defaults import (default_config_parser,
                                                         default_setup)

        opts = {**options, "seed": self.program_seed, **self.options}
        if self.device != "cuda":
            opts["device"] = self.device
        return default_setup(default_config_parser(self.config_file, opts))
