"""PyTorch port vs JAX package: the pretrain slice's backbone in bf16, the
windowed conv entry point, and the pretrain CLI on the CPU.

- SpUNet-v1m1 with ``compute_dtype`` bf16 (the pretrain config's) against
  the JAX SpUNet in bf16 on a synthetic RGB-D batch, train and eval mode:
  the features within 3e-2 of max|ref|, the bound ``bench.py:227`` applies
  between conv implementations in bf16 (both sides round the conv inputs,
  BN and packed convs to bf16 at slightly different places). The grads are
  held in f32 (``test_torch_pretrain_step.py``, ``test_torch_train.py``):
  in bf16 the two frameworks' backward passes round the cotangents at other
  places, and the stem's weight grad, summed over every row, differs by up
  to 16% of its max.
- ``tools/experiments/probe_windowed_torch.py:windowed_conv``, the entry
  point that runs K4 and K5, on its CPU tensors (the plain versions),
  against a dense per-tap gather conv wherever the geometry covers.
- ``tools/train_torch.py`` on ``configs/_test_/pretrain_synthetic.py`` with
  ``device=cpu``: two PonderIndoor-v2 steps and a checkpoint.
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ponderv2_tpu.models import build_model as jbuild
from ponderv2_tpu.models.default import batch_to_sparse_tensor as jto_sparse
from ponderv2_tpu.ops.sparse import maybe_sort_by_key as jsort
from ponderv2_tpu_torch.models import build_model as tbuild
from ponderv2_tpu_torch.models.default import batch_to_sparse_tensor
from ponderv2_tpu_torch.ops.sparse import maybe_sort_by_key
from ponderv2_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.join(ROOT, "tools", "experiments"))
from convert_torch_checkpoint import convert_spunet_v1m1  # noqa: E402
import probe_windowed_torch as probe  # noqa: E402
from test_torch_pretrain_step import CFG, pretrain_batch  # noqa: E402

BF16_BOUND = 3e-2


@pytest.fixture(autouse=True)
def _torch_state():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


def assert_rel(out, ref, bound, where="", scale=None):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (where, out.shape, ref.shape)
    scale = np.abs(ref).max() if scale is None else scale
    err = np.abs(out - ref).max()
    assert err <= bound * scale, f"{where}: err {err:.3e} vs {bound} x {scale:.3e}"


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_backbone_bf16_matches_jax_bf16(train):
    arrays = pretrain_batch()
    bcfg = dict(CFG.model.backbone)
    channels, layers = bcfg["channels"], bcfg["layers"]
    ctx = dict(spatial_shape=tuple(CFG.sparse_shape), batch_size=2)
    model = tbuild(dict(bcfg, compute_dtype="bfloat16"))
    model.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for name, b in list(model.named_parameters()) + list(model.named_buffers()):
            if b.ndim == 1:  # BN scale, bias and running stats
                lo, hi = {"weight": (0.5, 1.5), "bias": (-0.2, 0.2),
                          "running_mean": (-0.2, 0.2),
                          "running_var": (0.5, 2.0)}[name.rsplit(".", 1)[1]]
                b.copy_(torch.from_numpy(rng.uniform(lo, hi, b.shape)))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = convert_spunet_v1m1(sd, channels, layers)
    jmodel = jbuild(dict(bcfg, compute_dtype=jnp.bfloat16, remat=False))
    jst, _ = jsort(jto_sparse({**{k: jnp.asarray(v) for k, v in arrays.items()}, **ctx}))
    jout, _ = jmodel.apply({"params": params, "batch_stats": stats}, jst, train=train,
                           mutable=["batch_stats", "diagnostics"])

    model.train(train)
    st, _ = maybe_sort_by_key(batch_to_sparse_tensor(
        {**{k: torch.from_numpy(v) for k, v in arrays.items()}, **ctx}))
    with torch.no_grad():
        out, ok = model(st)
    assert bool(ok)
    # both heads return f32 features (BN and ReLU after the last bf16 conv)
    assert out.dtype == torch.float32 and np.asarray(jout).dtype == np.float32
    assert_rel(out.numpy(), np.asarray(jout, np.float32), BF16_BOUND, "features")


@pytest.mark.parametrize("wb", [1024, 32], ids=["covered", "uncovered"])
def test_windowed_conv_entry_point_on_cpu(wb):
    """The probe's entry point on CPU tensors: K4's output rows and K5's dW
    equal a per-tap gather conv of the in-window entries (all entries when
    a window spans every row); the covered share and the live-entry count
    that the bound uses agree with the geometry."""
    rng = np.random.RandomState(1)
    n, block, k3, cin, cout, group = 600, 64, 27, 8, 6, 9
    rb = torch.from_numpy(probe.make_monotone_rulebook(n, k3, rng, group=group))
    feats, w, g = probe.case_inputs(rb, cin, cout, 0, torch.device("cpu"))
    geom, out, dw = probe.windowed_conv(rb, feats, w, g, block, wb, group,
                                        torch.float32)
    share = probe.covered_share(geom, wb)
    assert (share == 1.0) == bool(geom.covered) == (wb == 1024)
    lo = (geom.w0.to(torch.int64) * wb).repeat_interleave(group, 0)
    lo = lo.repeat_interleave(block, 1)[:, :n]
    live = (rb >= lo) & (rb < lo + 2 * wb)
    assert probe.live_entries(geom, wb) == int(live.sum())
    assert (wb == 1024) == bool((live == (rb >= 0)).all())
    ref_out = torch.zeros(n, cout)
    ref_dw = torch.zeros(k3, cin, cout)
    for t in range(k3):
        x = torch.where(live[t, :, None], feats[rb[t].clamp(min=0)], 0.0)
        ref_out += x @ w[t]
        ref_dw[t] = x.T @ g
    assert_rel(out.numpy(), ref_out.numpy(), 1e-5, "K4")
    assert_rel(dw.numpy(), ref_dw.numpy(), 1e-5, "K5")
    ms, term = probe.bound_ms(geom, wb, cin, cout, n, torch.bfloat16)
    assert ms > 0 and term in ("bytes", "operations")


def test_train_torch_cli_pretrain_on_cpu(tmp_path):
    """``tools/train_torch.py`` on the tiny PonderIndoor-v2 config, one
    epoch of 2 steps on the CPU: a log line per step with the render
    losses, and a checkpoint that loads into a fresh model."""
    cfg_file = os.path.join(ROOT, "configs/_test_/pretrain_synthetic.py")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "train_torch.py"),
         "--config-file", cfg_file, "--options", f"save_path={tmp_path}",
         "device=cpu"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = (tmp_path / "train.log").read_text()
    assert log.count("Train: [1/1][") == 2 and "rgb_loss" in log
    ckpt = torch.load(tmp_path / "model" / "model_last.pth", weights_only=True)
    assert ckpt["step"] == 2
    model = tbuild(dict(Config.fromfile(cfg_file).model))
    model.load_state_dict(ckpt["state_dict"])
    assert all(torch.isfinite(v).all() for v in model.state_dict().values())
