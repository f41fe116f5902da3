"""The port's probe kernels (families A-D, and K4 at P3 ``k2``'s shape)
against the JAX package's own Pallas probe bodies, on the CPU.

Each probe of ``tools/experiments/probe_pallas_{gather,bisect,bisect2,
bisect3}.py`` runs unchanged at its own shape, with
``jax.experimental.pallas.pallas_call`` patched to run every kernel in
interpret mode and to record each call's arguments and output (a
``jax.debug.callback`` inside the probe's jit keeps the first run's
values). ``probe_pallas_profile.py`` (P7) is too large for interpret mode
(N = 163,840, a 320 x 27 grid): its calls are captured (kernel body, block
specs, arguments) and raise, and each body is run again with its own specs
over a cut grid, N = 4096 and 3 taps, on the probe's rulebook generator at
that size. A probe prints FAIL and carries on when a call raises, so every
expected kernel is asserted to have been captured with an output.

The same numpy inputs then go through the port's functions on CPU tensors
(their plain versions), and through the probe entry points' case generators
(``tools/experiments/probe_{gather,bisect,windowed}_torch.py``), which must
rebuild the probes' inputs from the seed. Tolerances:

- equal: P1, P2 (a row copy), P3 ``k0``/``k1`` and P4 A-D (f32 sums of the
  same bf16 values, taps in the TPU grid's order), P5 ``ka``, ``kb``,
  ``kc2`` (exact small integers and copies);
- within 1e-5 of max|ref|: P3 ``k2`` (K4), P5 ``kd``, P7 V1-V4 (f32 sums of
  bf16 products in another order than XLA's dot);
- P7 V5: within one bf16 ulp of each window-head sum (summed over the taps
  and the two heads of a block): ``jnp.sum`` of a bf16 row rounds XLA's f32
  reduction, which adds in another order than the port's columns in order.
"""

import contextlib
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas
from jax.experimental.pallas import tpu as pltpu

from ponderv2_tpu_torch.ops import probe_kernels as pk
from ponderv2_tpu_torch.ops import row_gather as rg
from ponderv2_tpu_torch.ops import windowed_gather as wg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools", "experiments"))
import probe_bisect_torch as pb  # noqa: E402
import probe_gather_torch as pg  # noqa: E402
import probe_pallas_bisect  # noqa: E402
import probe_pallas_bisect2  # noqa: E402
import probe_pallas_bisect3  # noqa: E402
import probe_pallas_gather  # noqa: E402
import probe_pallas_profile  # noqa: E402
import probe_windowed_torch as pw  # noqa: E402
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)

CPU = torch.device("cpu")
EXPECTED = {
    "P1": "probe_pallas_gather:main.<locals>.kernel_take",
    "P2": "probe_pallas_gather:probe_full_length.<locals>.kernel",
    "P3 k0": "probe_pallas_bisect:main.<locals>.k0",
    "P3 k1": "probe_pallas_bisect:main.<locals>.k1",
    "P3 k2": "probe_pallas_bisect:main.<locals>.k2",
    "P4 A": "probe_pallas_bisect2:main.<locals>.a.<locals>.k",
    "P4 B": "probe_pallas_bisect2:main.<locals>.b.<locals>.k",
    "P4 C": "probe_pallas_bisect2:main.<locals>.c.<locals>.k",
    "P4 D": "probe_pallas_bisect2:main.<locals>.d.<locals>.k",
    "P5 ka": "probe_pallas_bisect3:main.<locals>.ka",
    "P5 kb": "probe_pallas_bisect3:main.<locals>.kb",
    "P5 kc2": "probe_pallas_bisect3:main.<locals>.kc2",
    "P5 kd": "probe_pallas_bisect3:main.<locals>.kd",
}
# probe_pallas_profile.py's launches, in order (V1 is covered by K4)
PROFILE_RUNS = ["V1", "V2", "V3", "V4", "V5"]
PROFILE_BODIES = ["kern_full", "kern_norbc", "kern_norbc", "kern_lo", "kern_dma2"]


class _Captured(Exception):
    """Raised in place of a profile call once it is recorded."""


@contextlib.contextmanager
def _recorded_pallas_calls(module, capture_only=False):
    """Patch ``pallas_call`` while ``module``'s probe runs. Each call appends
    a record (name, kernel, keyword arguments, arguments); it then runs in
    interpret mode and its first run's arguments and output land in the
    record's ``values``, or, with ``capture_only``, it raises."""
    calls = []
    original = pallas.pallas_call

    def patched(kernel, *spec_args, **kwargs):
        kwargs = dict(kwargs, interpret=True)

        def call(*args):
            rec = {"name": f"{module.__name__}:{kernel.__qualname__}",
                   "kernel": kernel, "kwargs": kwargs, "args": args}
            calls.append(rec)
            if capture_only:
                raise _Captured(rec["name"])
            out = original(kernel, *spec_args, **kwargs)(*args)

            def keep(*values):
                rec.setdefault("values", [np.asarray(v) for v in values])

            jax.debug.callback(keep, *args, out)
            return out

        return call

    with mock.patch.object(pallas, "pallas_call", patched):
        yield calls
    jax.effects_barrier()


@pytest.fixture(scope="module")
def probe_calls():
    """{name: record} of every call the probes P1-P5 make, run at their own
    shapes; and the list of probe_pallas_profile.py's captured calls."""
    records = {}
    for module, entries in ((probe_pallas_gather, ("main", "probe_full_length")),
                            (probe_pallas_bisect, ("main",)),
                            (probe_pallas_bisect2, ("main",)),
                            (probe_pallas_bisect3, ("main",))):
        with _recorded_pallas_calls(module) as calls:
            for entry in entries:
                getattr(module, entry)()
        records.update({rec["name"]: rec for rec in calls})
    with _recorded_pallas_calls(probe_pallas_profile, capture_only=True) as profile:
        probe_pallas_profile.main()
    return records, profile


def _values(probe_calls, key):
    rec = probe_calls[0].get(EXPECTED[key])
    assert rec is not None and "values" in rec, f"{key} was not captured with an output"
    return rec["values"]


def _torch(a):
    """A captured array as a CPU tensor (bf16 kept as bf16)."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _assert_agrees(out, ref, tol, what):
    out = out.numpy() if torch.is_tensor(out) else out
    assert out.shape == ref.shape and out.dtype == ref.dtype == np.float32, what
    if isinstance(tol, np.ndarray):
        assert (np.abs(out - ref) <= tol).all(), what
    elif tol == "exact":
        np.testing.assert_array_equal(out, ref, err_msg=what)
    else:
        assert tol == "rel", tol
        err = np.abs(out - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), f"{what}: {err:.3e}"


def _tool_variant(variants, name):
    return next(v for v in variants if v.name.startswith(name))


def test_every_probe_kernel_is_captured(probe_calls):
    records, profile = probe_calls
    for key, name in EXPECTED.items():
        assert name in records and "values" in records[name], key
    assert [rec["kernel"].__name__ for rec in profile] == PROFILE_BODIES


@pytest.mark.parametrize("key,line", [("P1", 27), ("P2", 82)])
def test_row_gather_matches_probe(probe_calls, key, line):
    """P1/P2: ``row_gather`` of the probe's table and index view equals the
    interpret-mode kernel; so does the entry point's case generator."""
    feats, idx, ref = _values(probe_calls, key)
    _assert_agrees(rg.row_gather(_torch(feats), _torch(idx)), ref, "exact", key)
    v = _tool_variant(pg.variants(CPU), key)
    assert v.replaces == f"{pg.PROBE}:{line}" and v.kernel is rg.GATHER_SUM
    _assert_agrees(v.run(False), ref, "exact", f"{key} (tool)")


@pytest.mark.parametrize("key", ["P3 k0", "P3 k1", "P3 k2"])
def test_bisect_matches_probe(probe_calls, key):
    """P3: ``k0`` is ``window_copy_sum`` over the probe's window table,
    ``k1`` ``window_gather_sum`` over its rulebook blocks, ``k2`` K4
    (``windowed_conv_fwd``) at group 1, whose ``prepare_geometry`` windows
    are the probe's wherever a block has a live entry."""
    w0, rb, feats, _, w, ref = _values(probe_calls, key)
    n, block, wb = pb.N, pb.B, pb.WB
    x, w0_t, rb_t = _torch(feats), _torch(w0), _torch(rb).reshape(4, n // block, block)
    if key == "P3 k0":
        out, tol = pk.window_copy_sum(x, w0_t, wb, block), "exact"
    elif key == "P3 k1":
        out, tol = rg.window_gather_sum(x, rb_t, w0_t, block, wb), "exact"
    else:
        geom = wg.prepare_geometry(rb_t.reshape(4, n), n, block, wb, 1)
        has_live = (rb_t >= 0).any(dim=2)
        assert torch.equal(geom.w0[has_live], w0_t[has_live]) and bool(geom.covered)
        out, tol = wg.windowed_conv_fwd(x, geom, _torch(w), wb, 1), "rel"
    _assert_agrees(out, ref, tol, key)
    _assert_agrees(_tool_variant(pb.variants(CPU), key).run(False), ref, tol,
                   f"{key} (tool)")


@pytest.mark.parametrize("key", ["P4 A", "P4 B", "P4 C", "P4 D"])
def test_bisect2_matches_probe(probe_calls, key):
    """P4: the window copy over 4 taps, its window ``j mod 8`` (A, B) or the
    prefetched ``w0[j]`` (C, D), D adding the first entry of its rb block."""
    vals = _values(probe_calls, key)
    feats, ref = vals[-2], vals[-1]
    nb, block, wb = pb.N // pb.B, pb.B, pb.WB
    if key in ("P4 A", "P4 B"):
        table = (torch.arange(nb, dtype=torch.int32) % (pb.N // wb)).expand(4, nb)
    else:
        table = _torch(vals[0]).expand(4, nb)
    add = _torch(vals[1]).view(4, nb, block)[:, :, 0] if key == "P4 D" else None
    _assert_agrees(pk.window_copy_sum(_torch(feats), table, wb, block, add), ref,
                   "exact", key)
    _assert_agrees(_tool_variant(pb.variants(CPU), key).run(False), ref, "exact",
                   f"{key} (tool)")


@pytest.mark.parametrize("key", ["P5 ka", "P5 kb", "P5 kc2", "P5 kd"])
def test_bisect3_matches_probe(probe_calls, key):
    """P5: the grouped-kernel constructs."""
    vals = _values(probe_calls, key)
    ref = vals[-1]
    if key == "P5 ka":
        out, tol = pk.slab_slots(_torch(vals[0])), "exact"
    elif key == "P5 kb":
        out, tol = pk.lane_concat(_torch(vals[0]), pb.C, 9), "exact"
    elif key == "P5 kc2":
        out, tol = pk.sum_rows(_torch(vals[0]), 9), "exact"
    else:
        out, tol = pk.tile_matmul(_torch(vals[0]), _torch(vals[1])), "rel"
    _assert_agrees(out, ref, tol, key)
    _assert_agrees(_tool_variant(pb.variants(CPU), key).run(False), ref, tol,
                   f"{key} (tool)")


CUT_N, CUT_K3 = 4096, 3


def _bf16_ulp(x):
    """One bf16 ulp (8 significant bits) of each value of ``x``; 0 at 0."""
    mag = torch.where(x == 0, torch.ones_like(x), x.abs())
    return torch.where(x == 0, torch.zeros_like(x), 2.0 ** (torch.floor(torch.log2(mag)) - 7))


@pytest.mark.parametrize("run", PROFILE_RUNS)
def test_profile_ablations_match_probe(probe_calls, run):
    """P7 V2-V5 (and V1, K4's function): the probe's captured body and block
    specs over a cut grid against the port's function on the same inputs."""
    rec = probe_calls[1][PROFILE_RUNS.index(run)]
    feats8, w, rb = pw.profile_inputs(CUT_N, CUT_K3)
    nb, n_pad, block, wb = CUT_N // pw.BLOCK, (CUT_N // pw.WB + 1) * pw.WB, pw.BLOCK, pw.WB
    w0 = pw.probe_w0(rb.reshape(CUT_K3, nb, block), wb, n_pad)
    jf = jnp.asarray(feats8).astype(jnp.bfloat16)
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    rbb = jnp.asarray(rb.reshape(CUT_K3, nb, 1, block))
    args = {"kern_full": (rbb, jnp.asarray(rb.reshape(CUT_K3, nb, block, 1)), jf, jf, jw),
            "kern_lo": (rbb, jf, jw)}.get(rec["kernel"].__name__, (rbb, jf, jf, jw))
    spec = rec["kwargs"]["grid_spec"]
    ref = np.asarray(pallas.pallas_call(
        rec["kernel"],
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(nb, CUT_K3), in_specs=spec.in_specs,
            out_specs=spec.out_specs),
        out_shape=jax.ShapeDtypeStruct((CUT_N, pw.PROFILE_C), jnp.float32),
        interpret=True)(jnp.asarray(w0), *args))

    x = torch.from_numpy(feats8).bfloat16().reshape(n_pad, pw.PROFILE_C)
    wt = torch.from_numpy(w).bfloat16()
    w0_t = torch.from_numpy(w0)
    geom = wg.WindowGeometry(torch.from_numpy(rb).reshape(CUT_K3, nb, 1, block), w0_t,
                             torch.tensor(True))
    if run == "V5":
        out = pk.window_head_sum(x, w0_t, wb, block)
        heads = pk.window_head_sums_plain(x, w0_t, wb)  # (taps, nb, 2)
        tol = _bf16_ulp(heads).sum(dim=(0, 2)).repeat_interleave(block)[:, None]
        _assert_agrees(out, ref, tol.numpy(), run)
    elif run == "V1":
        _assert_agrees(wg.windowed_conv_fwd(x, geom, wt, wb, 1), ref, "rel", run)
    else:
        windows, rebase = {"V2": (2, False), "V3": (2, True), "V4": (1, False)}[run]
        _assert_agrees(wg.windowed_slab_fwd(x, geom, wt, wb, 1, windows, rebase), ref,
                       "rel", run)
    assert np.abs(ref).max() > 0


def test_profile_tool_rebuilds_the_probe_inputs(probe_calls):
    """``probe_windowed_torch.py``'s P7 case generator draws the profile
    probe's own inputs at N = 163,840 (features, weights, rulebook, windows)
    and its variants run on them, one per ablation."""
    args = probe_calls[1][1]["args"]  # V2: w0, rbb, feats8, feats8, w
    feats8, w, rb = pw.profile_inputs()
    nb, n_pad = pw.N // pw.BLOCK, (pw.N // pw.WB + 1) * pw.WB
    np.testing.assert_array_equal(np.asarray(args[0]), pw.probe_w0(
        rb.reshape(pw.PROFILE_K3, nb, pw.BLOCK), pw.WB, n_pad))
    np.testing.assert_array_equal(np.asarray(args[1]), rb.reshape(pw.PROFILE_K3, nb, 1,
                                                                  pw.BLOCK))
    assert torch.equal(_torch(np.asarray(args[2])), torch.from_numpy(feats8).bfloat16())
    assert torch.equal(_torch(np.asarray(args[4])), torch.from_numpy(w).bfloat16())
    variants = pw.profile_variants(CPU)
    assert [v.name.split()[1] for v in variants] == ["V2", "V3", "V4", "V5"]
    assert [v.kernel for v in variants] == [wg.WINDOWED_SLAB_FWD] * 3 + [pk.WINDOW_HEAD_SUM]
    for v in variants:
        out = v.run(False)
        assert out.shape == (pw.N, pw.PROFILE_C) and bool(torch.isfinite(out).all())
        assert v.moved > 0 and v.flops > 0 and pw.bound_of(v.moved, v.flops, v.peak)[0] > 0


@pytest.mark.parametrize("windows,rebase", [(2, False), (2, True), (1, False)],
                         ids=["V2", "V3", "V4"])
def test_slab_bound_counts_the_slab_heads_read(windows, rebase):
    """The bytes behind P7 V2-V4's bound count the distinct rows the
    forward reads, the slab heads ``r & ~7`` of the live entries (less the
    window start for V3), here against a plain numpy count at the cut
    size; V3's rebased rows lie in its two windows."""
    feats8, w, rb = pw.profile_inputs(CUT_N, CUT_K3)
    nb, n_pad = CUT_N // pw.BLOCK, (CUT_N // pw.WB + 1) * pw.WB
    rbb = rb.reshape(CUT_K3, nb, pw.BLOCK)
    w0 = pw.probe_w0(rbb, pw.WB, n_pad)
    geom = wg.WindowGeometry(torch.from_numpy(rbb).reshape(CUT_K3, nb, 1, pw.BLOCK),
                             torch.from_numpy(w0), torch.tensor(True))
    lo = w0.astype(np.int64)[:, :, None] * pw.WB
    live = (rbb >= lo) & (rbb < lo + windows * pw.WB)
    heads = (rbb // 8 * 8 - (lo if rebase else 0))[live]
    assert pw.rows_read(geom, pw.WB, windows, slab=True, rebase=rebase) == len(set(heads))
    assert pw.rows_read(geom, pw.WB, windows) == len(set(rbb[live]))
    if rebase:
        assert 0 <= heads.min() and heads.max() < 2 * pw.WB
    assert len(set(heads)) < len(set(rbb[live]))


def test_single_type_kernels_refuse_other_dtypes():
    """The probes' bf16 kernels have no f32 entry point: a launch in f32 is
    refused before the library is loaded, and counts no launch."""
    for k in (pk.WINDOW_COPY_SUM, pk.WINDOW_HEAD_SUM, pk.LANE_CONCAT, pk.TILE_MATMUL,
              wg.WINDOWED_SLAB_FWD):
        before = k.launches
        with pytest.raises(TypeError):
            k.launch(torch.float32, CPU)
        assert k.launches == before and k.dtypes == (torch.bfloat16,)
    assert wg.WINDOWED_FWD.dtypes == rg.GATHER_SUM.dtypes == (torch.float32, torch.bfloat16)
