"""The correctness check fails what it must: the control (the plain
reference in TF32 in the program's place) and a run whose timed path is
broken underneath. These drive the whole of a run but the look for a card,
on the CPU at a small size, held to the cell's own limits. (The cell keeps
no state from fragment to fragment and spans no chips, so no step can
leave a state unchanged and no exchange between chips can be left out.)"""

import tempfile

import numpy as np
import torch

from benchmark.harness import core
from benchmark.tests import small

CELL = "scannet-semseg-test"
SEED = 2 ** 31 + 5


def run_cell(controls=()):
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = small.ctx(CELL, SEED, 2.0, tmp, controls)
        _, program, ctrl = core.driver(ctx.mix["driver"]).run(ctx)
    return ctx.limits, program, ctrl


def correct(limits, readings) -> bool:
    check = core.Check(limits)
    for k, v in readings.items():
        check.add(k, v)
    return check.correct


def test_the_control_is_not_correct():
    limits, program, ctrl = run_cell(controls=("tf32",))
    assert set(program) == set(limits)
    assert correct(limits, program), program
    assert not correct(limits, {**program, **ctrl["tf32"]}), ctrl


def test_half_of_a_fragments_rows_left_out(monkeypatch):
    from ponderv2_tpu_torch.engines import test as engine

    collate_fn = engine.collate_fn

    def half(batch, **k):
        frag = dict(batch[0])
        n = len(frag["index"])
        keep = np.arange(n) < n - n // 2
        frag = {key: v[keep] if isinstance(v, np.ndarray) and len(v) == n else v
                for key, v in frag.items()}
        frag["offset"] = np.array([int(keep.sum())])
        return collate_fn([frag], **k)

    monkeypatch.setattr(engine, "collate_fn", half)
    limits, program, _ = run_cell()
    assert program["input_mismatch"] > 0
    assert not correct(limits, program), program


def test_half_of_a_fragments_answers_left_out(monkeypatch):
    from ponderv2_tpu_torch.engines.test import TesterBase

    eval_fragment = TesterBase.eval_fragment

    def half(self, arrays):
        out = eval_fragment(self, arrays)
        n = int((np.asarray(arrays["batch"]) >= 0).sum())
        out["seg_logits"][n // 2:n] = 0.0
        return out

    monkeypatch.setattr(TesterBase, "eval_fragment", half)
    limits, program, _ = run_cell()
    assert not correct(limits, program), program


def test_a_vote_altered_where_it_is_produced(monkeypatch):
    from ponderv2_tpu_torch.engines import test as engine

    class AlteredSave:
        def __getattr__(self, name):
            return getattr(np, name)

        @staticmethod
        def save(path, labels):  # the scene's labels as the tester saves them
            labels = np.array(labels)
            labels[: len(labels) // 100 + 1] += 1
            np.save(path, labels)

    monkeypatch.setattr(engine, "np", AlteredSave())
    limits, program, _ = run_cell()
    assert program["vote_mismatch"] > 0
    assert not correct(limits, program), program
