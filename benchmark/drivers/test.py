"""Test cells: the program's ``SemSegTester.test()`` over the val scenes,
every fragment of every rotation through ``eval_fragment``, as a user's
test run drives it.

Set-up writes the mix's scenes from the seed, makes the seeded weights
(their norms' running statistics calibrated by the plain reference on one
fragment of the benchmark's own voxelisation), saves them where the
recipe's ``weight`` points and takes them off the card, builds the
tester and runs that fragment through ``eval_fragment`` twice to build
and warm every kernel. The weights and their calibration are the
benchmark's work and are left out of ``setup_s``.

The window is ``test()`` itself: each scene's dataset work, each
fragment's collate, forward and vote. The benchmark's wrappers (its own,
around the tester's dataset, ``collate_fn`` and ``eval_fragment``) time
the host's work, close the window and keep each fragment's inputs and
logits for the check.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..counts.sparse import spunet_convs
from ..harness import core, scenes, weights
from ..harness.trace import BandRecorder, Tracer, Work
from ..reference import compare, fragments
from ..reference import spunet as ref


class _Dataset:
    """The tester's dataset, each ``__getitem__`` timed as host work."""

    def __init__(self, dataset, loop: "_Loop"):
        self.dataset, self.loop = dataset, loop

    def __len__(self):
        return len(self.dataset)

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def __getitem__(self, idx):
        t = time.perf_counter()
        self.loop.next_scene(t)
        out = self.dataset[idx]
        self.loop.run.span("scene_prep", time.perf_counter() - t)
        self.loop.scene = out["name"]
        return out


class _Loop:
    def __init__(self, ctx: core.Ctx, tester, run: core.Run):
        self.ctx, self.tester, self.run = ctx, tester, run
        self.trace_after = int(ctx.mix["trace_after"])
        self.trace_units = int(ctx.mix["trace_fragments"])
        self.deadline = None
        self.window_start = None
        self.window_end = None
        self.counted = None  # fragments finished inside the window
        self.scene = None
        self.finished = 0  # scenes voted to the end
        self.fragments: List[Dict] = []
        self.tracer = Tracer() if ctx.trace else None
        self.recorder = BandRecorder() if ctx.trace else None
        self.traced_rows: List[np.ndarray] = []
        self.eval_fragment = tester.eval_fragment

    def close(self, now: float) -> None:
        """The window ends at the first fragment or scene due after the
        deadline; every earlier fragment has been voted by then."""
        if self.window_end is None and now >= self.deadline:
            self.window_end, self.counted = now, len(self.fragments)

    def next_scene(self, now: float) -> None:
        if self.scene is not None:
            self.finished += 1
        self.close(now)
        if self.window_end is not None and self.finished:
            raise core.WindowClosed

    def collate(self, collate_fn):
        def timed(*a, **k):
            t = time.perf_counter()
            out = collate_fn(*a, **k)
            self.run.span("collate", time.perf_counter() - t)
            return out

        return timed

    def fragment(self, arrays):
        self.close(time.perf_counter())
        if self.window_end is not None and self.finished:
            raise core.WindowClosed
        # with no scene voted to the end yet, the scene in progress runs on
        # past the window for the check
        i = len(self.fragments)
        if self.tracer is not None:
            if i == self.trace_after:
                self.recorder.install()
                self.tracer.start()
            elif self.tracer.active and i == self.trace_after + self.trace_units:
                self.stop_trace()
        batch = np.asarray(arrays["batch"])
        valid = batch >= 0
        n = int(np.count_nonzero(valid))
        # the collate pads after the rows, so the rows kept for the check are
        # copied as a prefix (a mask over every padded row costs the window
        # some 20 ms a fragment); a mask where they are not one
        keep = slice(0, n) if valid[:n].all() else valid

        def rows(a):
            return np.array(np.asarray(a)[keep])

        grid = rows(arrays["grid_coord"])
        if self.tracer is not None and self.tracer.active:
            self.recorder.unit = len(self.traced_rows)
            self.traced_rows.append(np.concatenate([rows(batch)[:, None], grid], 1))
        out = self.eval_fragment(arrays)
        self.fragments.append(dict(
            scene=self.scene,
            frag=fragments.Fragment(rows(batch), grid, rows(arrays["feat"]),
                                    rows(arrays["index"])),
            logits=rows(out["seg_logits"]),
            ok=bool(out.get("contract_ok", True))))
        return out

    def stop_trace(self):
        self.run.trace = self.tracer.stop()
        self.recorder.remove()


def votes(frags: List[Dict], num_points: int, num_classes: int) -> np.ndarray:
    """A scene's labels from its fragments' logits, summed as the tester's
    vote sums them (softmax in f32, added by point index, fragment order)."""
    pred = np.zeros((num_points, num_classes), np.float32)
    for f in frags:
        logits = f["logits"]
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        pred[f["frag"].index] += probs
    return pred.argmax(-1)


def run(ctx: core.Ctx):
    """Returns (the run's record, the program's readings, the controls'
    readings by precision)."""
    from ponderv2_tpu_torch.engines import test as test_engine
    from ponderv2_tpu_torch.engines.common import split_batch, with_condition

    mix = ctx.mix
    run = core.Run(ctx.workload, "test", ctx.t0)
    phase = run.phase
    phase("imports")
    if ctx.device == "cuda":  # the program's context, made before the benchmark's work
        torch.zeros(1, device=ctx.device)
        torch.cuda.synchronize()
    phase("cuda")
    root = os.path.join(ctx.tmp, "scannet")
    written = scenes.write_scannet_scenes(root, "val", int(mix["scenes"]),
                                          int(mix["points"]), ctx.seed)
    weight = os.path.join(ctx.tmp, "weight.pth")
    save = os.path.join(ctx.tmp, "exp")
    cfg = ctx.parse_config({"data.test.data_root": root, "data.val.data_root": root,
                            "data.train.data_root": root, "save_path": save,
                            "weight": weight})
    budget = cfg.get("point_budget_test", cfg.get("point_budget"))
    pipeline = fragments.Pipeline.from_config(dict(cfg.data.test))
    phase("scenes")

    # the benchmark's own set-up (left out of setup_s): the seeded weights,
    # their norm statistics from one fragment of its own voxelisation, the
    # checkpoint the tester loads; then the weights leave the card, so that
    # the peak is the program's
    arch = ref.arch_from_config(dict(cfg.model.backbone))
    params = weights.seeded_params(ref.param_specs(arch), ctx.seed, ctx.device)
    warm = pipeline.first_fragment(written[0])
    ref.calibrate_norms(arch, params, _rows(warm["grid_coord"], ctx.device),
                        torch.as_tensor(warm["feat"], device=ctx.device))
    params = {k: v.cpu() for k, v in params.items()}
    torch.save(params, weight)
    if ctx.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    phase("weights", benchmark=True)

    # the program's matmuls run as the configuration states
    tf32 = bool(cfg.get("allow_tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    tester = test_engine.TESTERS.build(dict(type=cfg.test.type, cfg=cfg))
    collate_fn = test_engine.collate_fn
    phase("tester")
    arrays = with_condition(*split_batch(collate_fn([dict(warm)], point_budget=budget,
                                                    scene_budget=1)))
    for _ in range(2):
        tester.eval_fragment(arrays)
    tester.fragment_seconds.clear()
    tester.contract_ok.clear()
    del arrays

    loop = _Loop(ctx, tester, run)
    tester.test_dataset = _Dataset(tester.test_dataset, loop)
    tester.eval_fragment = loop.fragment
    test_engine.collate_fn = loop.collate(collate_fn)
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    phase("warm-up")
    now = time.perf_counter()
    run.setup_s = now - ctx.t0 - run.benchmark_s
    loop.window_start, loop.deadline = now, now + ctx.seconds
    try:
        tester.test()
        raise RuntimeError("the tester ran out of scenes inside the window: raise the "
                           f"mix's scenes ({mix['scenes']})")
    except core.WindowClosed:
        pass
    finally:
        test_engine.collate_fn = collate_fn
    if loop.tracer is not None and loop.tracer.active:
        loop.stop_trace()
    frags = loop.fragments
    run.window_s = loop.window_end - loop.window_start
    run.count = run.attempted = loop.counted
    run.failed = sum(not f["ok"] for f in frags[:loop.counted])
    run.unit_s = list(tester.fragment_seconds[:loop.counted])
    if ctx.device == "cuda":
        torch.cuda.synchronize()
        run.peak_bytes = torch.cuda.max_memory_allocated()
    calls = loop.recorder.calls if loop.recorder is not None else []
    traced_rows, counted = loop.traced_rows, loop.counted
    del tester, loop
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()

    if ctx.trace:
        work = Work(spunet_convs(dict(cfg.model.backbone)),
                    cfg.model.backbone.get("compute_dtype") or torch.float32, False)
        for r in traced_rows:
            work.add_unit(torch.as_tensor(r, dtype=torch.int64, device=ctx.device))
        work.count_band_calls(calls)
        run.work = work
    del calls

    t_check = time.perf_counter()
    params = {k: v.to(ctx.device) for k, v in params.items()}
    program, controls = check(ctx, cfg, arch, params, pipeline, written, frags,
                              counted or len(frags), save)
    run.check_s = time.perf_counter() - t_check
    return run, program, controls


def _rows(grid: np.ndarray, device) -> torch.Tensor:
    """(batch 0, voxel) rows of one fragment."""
    return torch.as_tensor(np.concatenate([np.zeros((len(grid), 1), np.int64), grid], 1),
                           dtype=torch.int64, device=device)


def check(ctx, cfg, arch, params, pipeline, written, frags, counted, save):
    """The numbers compared:

    - ``input_mismatch``: of every fragment the window handed the model,
      the rows that the benchmark's own voxelisation of the scene
      (``reference.fragments``) does not give, and of each scene voted to
      the end, the fragments and points missing (exact; limit 0);
    - ``logit_gap``: the largest, over the window's fragments, of max
      |program - reference| / max |reference| of a fragment's logits, the
      reference run on the benchmark's rows and features of the points the
      program's fragment holds;
    - ``vote_mismatch``: points of each scene voted to the end whose label,
      voted again from the program's fragment logits as the tester votes,
      differs from the label the tester saved (exact; limit 0)."""
    by_scene: Dict[str, List[int]] = {}
    for i, f in enumerate(frags):
        by_scene.setdefault(f["scene"], []).append(i)
    done = [s for s in by_scene
            if os.path.isfile(os.path.join(save, "result", f"{s}_pred.npy"))]
    if not done:
        raise RuntimeError("no scene finished inside the window")
    program = {"input_mismatch": 0.0, "logit_gap": 0.0, "vote_mismatch": 0.0}
    controls = {p: {"logit_gap": 0.0} for p in ctx.controls}
    for name, at in by_scene.items():
        scene = pipeline.scene(written[int(name[len("scene"):len("scene") + 4])])
        if name in done:
            program["input_mismatch"] += fragments.coverage_mismatch(
                scene, [frags[i]["frag"].index for i in at])
            labels = np.load(os.path.join(save, "result", f"{name}_pred.npy"))
            mine = votes([frags[i] for i in at], len(labels), int(cfg.data.num_classes))
            program["vote_mismatch"] += float((mine != labels).sum())
        for k, i in enumerate(at):
            f = frags[i]
            bad, want = fragments.mismatch(scene, fragments.rotation_of(scene, k), f["frag"])
            program["input_mismatch"] += bad
            if i >= counted or want is None:
                continue
            coords = _rows(want[0], ctx.device)
            feat = torch.as_tensor(want[1], device=ctx.device)
            base = ref.eval_logits(arch, params, coords, feat, ref.Precision())
            base = base.double().cpu().numpy()
            program["logit_gap"] = max(program["logit_gap"],
                                       compare.logit_gap(f["logits"], base))
            for p in ctx.controls:
                other = ref.eval_logits(arch, params, coords, feat, ref.Precision(p))
                controls[p]["logit_gap"] = max(controls[p]["logit_gap"], compare.logit_gap(
                    other.cpu().numpy(), base))
    return program, controls
