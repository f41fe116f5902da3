"""PyTorch port vs JAX package: the pretrain step's modules on the CPU.

Each comparison feeds the same numpy inputs, made from a seed, to the JAX
function and to the port: the segment reductions, the trilinear smooth
sampler (values, first and second derivatives), UNet3D-v1m2 (train and
eval), the ray samplers with the JAX draws handed over, the SDF field, the
render losses, the checkpoint converter, the windowed gather geometry and
K4/K5's plain versions against the Pallas kernels in interpret mode.
Tolerances: integers exactly; f32 values 1e-5 relative (sums in another
order); gradients 1e-4 of max|ref|.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ponderv2_tpu.models.ponder.render import samplers as jsamplers
from ponderv2_tpu.models.ponder.render.fields import SDFField as JSDFField
from ponderv2_tpu.models.ponder.render.surface_models import NeuSModel as JNeuSModel
from ponderv2_tpu.models.ponder.unet3d import UNet3Dv1m2 as JUNet3D
from ponderv2_tpu.ops import interp as jinterp
from ponderv2_tpu.ops import pallas_gather as jpg
from ponderv2_tpu.ops import scatter as jscatter
from ponderv2_tpu_torch.engines.test import SemSegTester
from ponderv2_tpu_torch.engines.train import Trainer
from ponderv2_tpu_torch.models.ponder.render import samplers as tsamplers
from ponderv2_tpu_torch.models.ponder.render.fields import SDFField
from ponderv2_tpu_torch.models.ponder.render.surface_models import NeuSModel
from ponderv2_tpu_torch.models.ponder.unet3d import UNet3Dv1m2
from ponderv2_tpu_torch.ops import interp as tinterp
from ponderv2_tpu_torch.ops import scatter as tscatter
from ponderv2_tpu_torch.ops import windowed_gather as twg
from ponderv2_tpu_torch.utils.config import Config
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)


@pytest.fixture(autouse=True)
def _torch_state():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


def assert_rel(out, ref, bound, where="", scale=None):
    """max|out - ref| <= bound * max|ref|, or ``bound * scale`` where a
    scale is given; an all-zero ref (a grad that is zero by construction)
    must be matched by zeros."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (where, out.shape, ref.shape)
    scale = np.abs(ref).max() if scale is None else scale
    err = np.abs(out - ref).max()
    assert err <= bound * scale, f"{where}: err {err:.3e} vs {bound} x {scale:.3e}"


def assert_grads(grads, refs, bound, prefix=""):
    """Each grad within ``bound`` of its max|ref|. A grad whose ref is below
    ``bound`` of the largest one is zero by construction up to f32
    cancellation (a conv bias ahead of a training-mode BN): it is held to
    ``bound`` of the largest ref instead."""
    top = max(np.abs(np.asarray(refs[prefix + n])).max() for n in grads)
    for name, g in grads.items():
        ref = refs[prefix + name]
        floor = top if np.abs(np.asarray(ref)).max() < bound * top else None
        assert_rel(g, ref, bound, f"grad {name}", scale=floor)


def t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------- the repair


@pytest.mark.parametrize("entry", ["trainer", "tester"])
def test_entry_points_raise_without_cuda_unless_asked_for_cpu(monkeypatch, entry):
    """Without CUDA and without ``device``, Trainer and SemSegTester refuse
    to run (they name ``device=cpu``) instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cls = Trainer if entry == "trainer" else SemSegTester
    cfg = Config(dict(save_path=None, seed=0, model=dict(type="missing")))
    with pytest.raises(RuntimeError, match="device=cpu"):
        cls(cfg)


# ------------------------------------------------------------- scatter


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_segment_reductions_match_jax(rng, op):
    data = rng.randn(300, 5).astype(np.float32)
    ids = rng.randint(-2, 23, 300).astype(np.int32)  # negative and too-large ids
    num = 20  # some segments empty
    kw = {"initial": 7.0} if op in ("max", "min") else {}
    ref = getattr(jscatter, f"segment_{op}")(jnp.asarray(data), jnp.asarray(ids), num, **kw)
    out = getattr(tscatter, f"segment_{op}")(t(data), t(ids), num, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- interp


@pytest.mark.parametrize("smoothstep", [False, True])
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_3d_matches_jax(rng, smoothstep, align_corners, padding_mode):
    vol = rng.randn(2, 3, 5, 6, 7).astype(np.float32)
    pts = rng.rand(2, 50, 3).astype(np.float32) * 2.4 - 1.2  # incl. out of bounds
    ref = jinterp.grid_sample_3d(jnp.asarray(vol), jnp.asarray(pts), align_corners,
                                 padding_mode, smoothstep)
    out = tinterp.grid_sample_3d(t(vol), t(pts), align_corners, padding_mode, smoothstep)
    assert_rel(out.numpy(), ref, 1e-5, "values")
    ref_f = jinterp.sample_feature_volume(jnp.asarray(vol), jnp.asarray(pts))
    assert_rel(tinterp.sample_feature_volume(t(vol), t(pts)).numpy(), ref_f, 1e-5, "feat")


def test_grid_sample_3d_first_and_second_derivatives_match_jax(rng):
    """d/dp of the sampled sum and d/dp of |d/dp|^2 (the eikonal
    double-backward path), and the second one's volume gradient."""
    vol = rng.randn(1, 2, 4, 4, 4).astype(np.float32)
    p0 = (rng.rand(1, 6, 3) * 1.2 - 0.6).astype(np.float32)

    def jf(v, p):
        return jnp.sum(jinterp.grid_sample_3d(v, p, smoothstep=True) ** 2)

    def jg(v, p):
        return jnp.sum(jax.grad(jf, argnums=1)(v, p) ** 2)

    jd1 = jax.grad(jf, argnums=1)(jnp.asarray(vol), jnp.asarray(p0))
    jd2v, jd2p = jax.grad(jg, argnums=(0, 1))(jnp.asarray(vol), jnp.asarray(p0))

    v = t(vol).requires_grad_()
    p = t(p0).requires_grad_()
    f = (tinterp.grid_sample_3d(v, p, smoothstep=True) ** 2).sum()
    d1, = torch.autograd.grad(f, p, create_graph=True)
    assert_rel(d1.detach().numpy(), jd1, 1e-5, "d/dp")
    d2v, d2p = torch.autograd.grad((d1 ** 2).sum(), (v, p))
    assert_rel(d2p.numpy(), jd2p, 1e-4, "d2/dp2")
    assert_rel(d2v.numpy(), jd2v, 1e-4, "d2/dp dv")


# ------------------------------------------------------------- UNet3D


def unet_weights(rng, model):
    """Seeded port weights with non-trivial BN scale/bias and running stats,
    and the JAX variables made from them by the JAX package's converter."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    from convert_torch_checkpoint import convert_unet3d_v1m2

    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, b in list(model.named_parameters()) + list(model.named_buffers()):
            if "batchnorm" in name:
                lo, hi = {"weight": (0.5, 1.5), "bias": (-0.2, 0.2),
                          "running_mean": (-0.2, 0.2), "running_var": (0.5, 2.0)}[
                    name.rsplit(".", 1)[1]]
                b.copy_(t(rng.uniform(lo, hi, b.shape).astype(np.float32)))
            elif name.endswith("bias"):
                b.copy_(t(rng.uniform(-0.1, 0.1, b.shape).astype(np.float32)))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = convert_unet3d_v1m2(sd, num_levels=3)
    return params, stats


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_unet3d_v1m2_matches_jax(rng, train):
    """Output, input and parameter grads, and the BN running stats after a
    training forward."""
    vol = rng.randn(2, 6, 8, 8, 4).astype(np.float32)
    cot = rng.randn(2, 5, 8, 8, 4).astype(np.float32)
    model = UNet3Dv1m2(in_channels=6, out_channels=5, f_maps=4, num_levels=3)
    params, stats = unet_weights(rng, model)
    jmodel = JUNet3D(in_channels=6, out_channels=5, f_maps=4, num_levels=3)

    def jfn(p, x):
        out, mut = jmodel.apply({"params": p, "batch_stats": stats}, x, train=train,
                                mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut)

    (_, (jout, jmut)), (jgp, jgx) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(vol))
    model.train(train)
    x = t(vol).requires_grad_()
    out = model(x)
    (out * t(cot)).sum().backward()
    assert_rel(out.detach().numpy(), jout, 1e-5, "out")
    assert_rel(x.grad.numpy(), jgx, 1e-4, "dx")
    from ponderv2_tpu_torch.utils.convert import _unet3d_v1m2

    jsd = {}
    _unet3d_v1m2(jsd, "m", jax.device_get(jgp), jax.device_get(jmut["batch_stats"]), 3)
    assert_grads({n: p.grad.numpy() for n, p in model.named_parameters()},
                 jsd, 1e-4, "m.")
    if train:
        for name, b in model.named_buffers():
            assert_rel(b.numpy(), jsd[f"m.{name}"], 1e-5, f"stat {name}")


# ------------------------------------------------------------- samplers


def _rays(rng, B=2, R=6):
    o = jnp.asarray(rng.rand(B, R, 3).astype(np.float32) * 0.3 + 0.1)
    d = rng.randn(B, R, 3).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
    return o, d


@pytest.mark.parametrize("spacing", ["uniform", "lindisp", "sqrt", "log",
                                     "uniform_lindisp_piecewise"])
@pytest.mark.parametrize("stratified", [False, True])
def test_spaced_bins_match_jax(rng, spacing, stratified):
    nears = rng.rand(2, 5).astype(np.float32) * 0.2 + 0.05
    fars = nears + rng.rand(2, 5).astype(np.float32) + 0.2
    key = jax.random.PRNGKey(3)
    js, je = jsamplers.spaced_bins(jnp.asarray(nears), jnp.asarray(fars), 7, spacing,
                                   stratified, key if stratified else None)
    u = np.asarray(jax.random.uniform(key, (2, 5, 8))) if stratified else None
    ts, te = tsamplers.spaced_bins(t(nears), t(fars), 7, spacing,
                                   None if u is None else t(u))
    assert_rel(ts.numpy(), js, 1e-5, "starts")
    assert_rel(te.numpy(), je, 1e-5, "ends")


@pytest.mark.parametrize("stratified", [False, True])
def test_pdf_sampler_matches_jax(rng, stratified):
    """Same bins from the same uniforms; the comparison-sum search gives the
    same indices (so the same samples) at ties too."""
    starts = np.sort(rng.rand(2, 5, 9).astype(np.float32), -1)
    ends = np.concatenate([starts[..., 1:], starts[..., -1:] + 0.1], -1)
    weights = rng.rand(2, 5, 9).astype(np.float32)
    weights[0, 0] = 0.0  # a flat cdf: every search ties
    key = jax.random.PRNGKey(5)
    js, je = jsamplers.PDFSampler(6)(jnp.asarray(starts), jnp.asarray(ends),
                                     jnp.asarray(weights), train=stratified, rng=key)
    u = t(np.asarray(jax.random.uniform(key, (2, 5, 7))))
    ts, te = tsamplers.PDFSampler(6)(t(starts), t(ends), t(weights),
                                     train=stratified, u=u)
    assert_rel(ts.numpy(), js, 1e-5, "starts")
    assert_rel(te.numpy(), je, 1e-5, "ends")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_neus_sampler_matches_jax(rng, train):
    """Two upsample steps over an analytic sdf (a sphere), with the JAX
    sampler's ``split(rng, steps + 1)`` draws handed to the port."""
    o, d = _rays(rng)
    nears = jnp.full((2, 6), 0.05, jnp.float32)
    fars = jnp.full((2, 6), 1.2, jnp.float32)
    key = jax.random.PRNGKey(7)
    js = jsamplers.NeuSSampler(num_samples=10, num_samples_importance=6,
                               num_upsample_steps=2)
    ts = tsamplers.NeuSSampler(num_samples=10, num_samples_importance=6,
                               num_upsample_steps=2)

    def jsdf(p):
        return jnp.linalg.norm(p - 0.5, axis=-1) - 0.3

    def tsdf(p):
        return torch.linalg.norm(p - 0.5, dim=-1) - 0.3

    jst, jen = js(nears, fars, jsdf, o, d, train=train, rng=key)
    keys = jax.random.split(key, 3)
    shapes = ts.draw_shapes((2, 6))
    assert shapes == ((2, 6, 11), (2, 6, 4), (2, 6, 4))
    draws = [t(np.asarray(jax.random.uniform(k, s))) for k, s in zip(keys, shapes)]
    tst, ten = ts(t(np.asarray(nears)), t(np.asarray(fars)), tsdf, t(np.asarray(o)),
                  t(np.asarray(d)), train=train, draws=draws if train else None)
    assert tst.shape == (2, 6, ts.total_samples())
    assert_rel(tst.numpy(), jst, 1e-5, "starts")
    assert_rel(ten.numpy(), jen, 1e-5, "ends")


# ------------------------------------------------------------- field, losses

FIELD = dict(hidden_dim=16, num_layers=2, geo_feat_dim=4, semantic_dim=8,
             share_volume=False)
FEATURE_DIM = 6


def field_weights(jfield, vol, o, d, starts, ends):
    """JAX field variables, and the port's SDFField with the same weights
    (through the port's converter)."""
    from ponderv2_tpu_torch.utils.convert import _residual_decoder

    variables = jfield.init(jax.random.PRNGKey(0), vol, o, d, starts, ends)
    fp = jax.device_get(variables["params"])
    sd = {}
    for name in ("sdf_decoder", "rgb_decoder", "semantic_decoder"):
        _residual_decoder(sd, name, fp[name])
    sd["deviation_network.variance"] = np.asarray(fp["deviation_network"]["variance"])
    field = SDFField(feature_dim=FEATURE_DIM, **FIELD)
    field.load_state_dict({k: t(v) for k, v in sd.items()})
    return variables, field


def _samples(rng, B=2, R=5, S=7):
    starts = np.sort(rng.rand(B, R, S).astype(np.float32), -1) * 0.8 + 0.05
    ends = np.concatenate([starts[..., 1:], starts[..., -1:] + 0.05], -1)
    return jnp.asarray(starts), jnp.asarray(ends)


def test_sdf_field_outputs_and_grads_match_jax(rng):
    """Outputs (sdf, spatial gradients, alphas, rgb, semantic, inv_s), the
    sdf of free points, and the grads of a loss through all of them
    (second-order through the gradients) w.r.t. the volume and every
    parameter."""
    vol = jnp.asarray(rng.randn(2, FEATURE_DIM, 5, 6, 4).astype(np.float32))
    o, d = _rays(rng, R=5)
    starts, ends = _samples(rng)
    jfield = JSDFField(**FIELD)
    variables, field = field_weights(jfield, vol, o, d, starts, ends)
    pts = jnp.asarray(rng.rand(2, 11, 3).astype(np.float32))
    keys = ("sdf", "gradients", "alphas", "rgb", "semantic")
    cots = {k: rng.randn(*s.shape).astype(np.float32) for k, s in jax.eval_shape(
        lambda: jfield.apply(variables, vol, o, d, starts, ends)).items() if k in keys}

    def jloss(params, v):
        out = jfield.apply({"params": params}, v, o, d, starts, ends)
        return sum(jnp.sum(out[k] * cots[k]) for k in keys) + out["inv_s"], out

    (_, jout), (jgp, jgv) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        variables["params"], vol)
    jsdf = jfield.apply(variables, vol, pts, method=JSDFField.get_sdf)

    v = t(np.asarray(vol)).requires_grad_()
    vol_cl = field.volume_channels_last(v)
    out = field(vol_cl, *(t(np.asarray(a)) for a in (o, d, starts, ends)))
    for k in keys + ("inv_s",):
        assert_rel(out[k].detach().numpy(), jout[k], 1e-5, k)
    assert_rel(field.get_sdf(vol_cl, t(np.asarray(pts))).detach().numpy(), jsdf, 1e-5,
               "get_sdf")
    loss = sum((out[k] * t(cots[k])).sum() for k in keys) + out["inv_s"]
    loss.backward()
    assert_rel(v.grad.numpy(), jgv, 1e-4, "d volume")
    from ponderv2_tpu_torch.utils.convert import _residual_decoder

    jsd = {}
    jgp = jax.device_get(jgp)
    for name in ("sdf_decoder", "rgb_decoder", "semantic_decoder"):
        _residual_decoder(jsd, name, jgp[name])
    jsd["deviation_network.variance"] = jgp["deviation_network"]["variance"]
    # fc_p's grads are exactly zero in both: points_factor is 0
    assert_grads({n: p.grad.numpy() for n, p in field.named_parameters()}, jsd, 1e-4)


def _loss_model(module, **loss):
    return module(loss=dict(sensor_depth_truncation=0.05, temperature=0.07,
                            weights=dict(rgb=10.0, depth=1.0, semantic=0.1,
                                         eikonal=0.01, free_space=1.0, sdf=10.0,
                                         sparse_sdf=0.1), **loss))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_render_losses_and_grads_match_jax(rng, train):
    """Every loss term and the grads of the total with respect to every
    render output; eval takes the chunk-local semantic contrast."""
    B, R, S, C, K = 2, 12, 5, 8, 6
    outputs = dict(
        rgb=rng.rand(B, R, 3), depth=rng.rand(B, R), semantic=rng.randn(B, R, C),
        sdf=rng.randn(B, R, S) * 0.1, gradients=rng.randn(B, R, S, 3),
        sample_depths=np.sort(rng.rand(B, R, S), -1), sparse_sdf=rng.randn(40) * 0.1)
    outputs = {k: v.astype(np.float32) for k, v in outputs.items()}
    sp_mask = rng.rand(40) > 0.2
    depth = (rng.rand(B, R) - 0.15).astype(np.float32)
    targets = dict(rgb=rng.rand(B, R, 3).astype(np.float32), depth=depth,
                   semantic=rng.randint(-1, K, (B, R)).astype(np.int32),
                   ray_mask=depth > 0)
    emb = rng.randn(K, C).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    jm = _loss_model(JNeuSModel, val_ray_split=8)
    tm = _loss_model(NeuSModel, val_ray_split=8)

    def jfn(outs):
        outs = dict(outs, sparse_sdf_mask=jnp.asarray(sp_mask))
        losses = jm.apply({"params": {}}, outs, {k: jnp.asarray(v) for k, v in targets.items()},
                          jnp.asarray(emb), train, method=JNeuSModel.get_loss)
        return losses["render_loss"], losses

    (_, jl), jg = jax.value_and_grad(jfn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outputs.items()})
    touts = {k: t(v).requires_grad_() for k, v in outputs.items()}
    tl = tm.get_loss(dict(touts, sparse_sdf_mask=t(sp_mask)),
                     {k: t(v) for k, v in targets.items()}, t(emb), train)
    assert sorted(tl) == sorted(jl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    tl["render_loss"].backward()
    for k, v in touts.items():
        assert_rel(v.grad.numpy(), jg[k], 1e-4, f"grad {k}")


# ------------------------------------------------------------- windowed gather


def monotone_rulebook(rng, n, k3, group, spread, miss=0.3):
    """Group-coherent per-tap shifts, as real rulebooks have
    (tools/experiments/probe_pallas_windowed.py:make_monotone_rulebook)."""
    rbs = []
    for tap in range(k3):
        shift = rng.randint(-spread, spread) if tap % group == 0 else shift
        idx = np.arange(n) + shift + tap % group * 3 + rng.randint(-4, 4, n)
        idx = np.clip(np.sort(idx), 0, n - 1)
        rbs.append(np.where(rng.rand(n) < miss, -1, idx))
    return np.stack(rbs).astype(np.int32)


# the window block wb: a 64-row output block's entries (tap offsets of up
# to 24 rows, jitter of 4) fit two 128-row blocks, but not two 32-row ones,
# so entries fall outside and are dropped
WINDOW_CASES = {"covered": 128, "uncovered": 32}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_windowed_gather_plain_matches_pallas_interpret(rng, case):
    """Geometry integer-equal; K4's and K5's plain versions against the
    Pallas kernels run in interpret mode, as the JAX package runs its
    kernels on the CPU."""
    n, block, k3, cin, cout, group = 300, 64, 27, 8, 6, 9
    wb = WINDOW_CASES[case]
    rb = monotone_rulebook(rng, n, k3, group, 20)
    jgeom = jpg.prepare_geometry(jnp.asarray(rb), n, block, wb, group)
    geom = twg.prepare_geometry(t(rb), n, block, wb, group)
    for name in ("rbb", "w0", "covered"):
        np.testing.assert_array_equal(getattr(geom, name).numpy(),
                                      np.asarray(getattr(jgeom, name)), err_msg=name)
    assert bool(geom.covered) == (case == "covered")
    assert twg.padded_rows(n, wb) == jpg.padded_rows(n, wb)

    x = rng.randn(n, cin).astype(np.float32)
    w = rng.randn(k3, cin, cout).astype(np.float32)
    n_pad = twg.padded_rows(n, wb)
    jf8 = jpg.pad_features(jnp.asarray(x), n_pad, jnp.float32)
    f = twg.pad_features(t(x), n_pad, torch.float32)
    np.testing.assert_array_equal(f.numpy().reshape(jf8.shape), np.asarray(jf8))
    jout = jpg.windowed_conv_fwd(jf8, jgeom, jnp.asarray(w), wb, group)
    out = twg.windowed_conv_fwd(f, geom, t(w), wb, group)
    assert_rel(out.numpy(), jout, 1e-5, "K4")
    g = rng.randn(out.shape[0], cout).astype(np.float32)
    jdw = jpg.windowed_conv_dw(jf8, jgeom, jnp.asarray(g), wb, group)
    dw = twg.windowed_conv_dw(f, geom, t(g), wb, group)
    assert_rel(dw.numpy(), jdw, 1e-5, "K5")
    if case == "covered":  # every entry counted: the plain gather conv
        dense = np.zeros((out.shape[0], cout), np.float32)
        for tap in range(k3):
            live = rb[tap] >= 0
            dense[:n][live] += x[rb[tap][live]] @ w[tap]
        assert_rel(out.numpy(), dense, 1e-5, "K4 vs gather conv")
