"""Nothing the harness runs loads JAX or the JAX package: top-level module
names are compared whole (``ponderv2_tpu_torch`` is not ``ponderv2_tpu``)."""

import os
import subprocess
import sys
import types

from benchmark.harness import core

BLOCKED = ("jax", "jaxlib", "flax", "optax", "ponderv2_tpu")

# run in a fresh interpreter with those names blocked: the harness's
# modules, every reader, then one small run of each cell on the CPU
SCRIPT = r"""
import importlib.abc, os, sys, tempfile
BLOCKED = %r
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".", 1)[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
import torch
torch.set_num_threads(2)
from benchmark.harness import core, readers, scenes, trace, weights
from benchmark.reference import compare, fragments, spunet
from benchmark.counts import sparse
import benchmark.run, benchmark.calibrate
from benchmark.tests import small
bench = core.benchmark()
for f in sorted(os.listdir(os.path.join(core.BENCH_DIR, "metrics"))):
    core.metric_reader(f[:-3])
for cell in bench["workloads"]:
    with tempfile.TemporaryDirectory() as tmp:
        ctx = small.ctx(cell["name"], 2 ** 31 + 11, 0.0, tmp)
        core.driver(ctx.mix["driver"]).run(ctx)
found = core.forbidden_modules()
assert not found, found
print("NOJAX-OK", sorted(m for m in sys.modules if m.startswith("benchmark")).__len__())
"""


def test_harness_runs_with_jax_blocked():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", SCRIPT % (BLOCKED, core.ROOT)],
                         capture_output=True, text=True, env=env, timeout=900,
                         cwd=core.ROOT)
    assert "NOJAX-OK" in out.stdout, out.stderr[-3000:]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ponderv2_tpu_torch_like", types.ModuleType("x"))
    assert core.forbidden_modules() == [] or "ponderv2_tpu" not in core.forbidden_modules()
    before = set(core.forbidden_modules())
    monkeypatch.setitem(sys.modules, "ponderv2_tpu.ops", types.ModuleType("ponderv2_tpu.ops"))
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    assert set(core.forbidden_modules()) - before == {"ponderv2_tpu", "flax"}
    # the repository's TPU-era scripts count only when loaded from the checkout
    tools = types.ModuleType("tools")
    tools.__file__ = os.path.join(core.ROOT, "tools", "__init__.py")
    monkeypatch.setitem(sys.modules, "tools", tools)
    assert "tools" in core.forbidden_modules()
