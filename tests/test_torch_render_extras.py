"""PyTorch port vs JAX package: the VolSDF and UniSurf render paths on the CPU.

The VolSDF helpers (``laplace_density``, ``volsdf_dstar``,
``volsdf_error_bound``), ``rays.get_weights_from_densities`` and
``merge_ray_samples``, ``ErrorBoundedSampler``, ``UniSurfSampler`` and
``NeuSAccSampler`` (train, with the JAX sampler's draws handed over, and
eval), and ``VolSDFModel``'s render, losses and grads with the JAX weights
carried across by the port's converter (``utils/convert.py``, the
``laplace_density`` beta included). Tolerances: integers exactly; f32
values within 1e-5 of max|ref|; grads within 1e-4 of max|ref| (second
order through the field's spatial gradient, as
``test_torch_pretrain_ops.py`` holds NeuS's).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ponderv2_tpu.models.ponder.render import rays as jrays
from ponderv2_tpu.models.ponder.render import samplers as jsamplers
from ponderv2_tpu.models.ponder.render.surface_models import VolSDFModel as JVolSDFModel
from ponderv2_tpu_torch.models.ponder.render import rays as trays
from ponderv2_tpu_torch.models.ponder.render import samplers as tsamplers
from ponderv2_tpu_torch.models.ponder.render.surface_models import RENDERERS, VolSDFModel
from ponderv2_tpu_torch.utils.convert import _render_model
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)


@pytest.fixture(autouse=True)
def _torch_state():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


def t(x):
    return torch.from_numpy(np.asarray(x))


def assert_rel(out, ref, bound, where=""):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (where, out.shape, ref.shape)
    scale = np.abs(ref).max()
    err = np.abs(out - ref).max()
    assert err <= bound * max(scale, 1e-30), f"{where}: err {err:.3e} vs {scale:.3e}"


def rays(rng, B=2, R=6):
    o = rng.rand(B, R, 3).astype(np.float32) * 0.3 + 0.1
    d = rng.randn(B, R, 3).astype(np.float32)
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def jsphere(p):
    return jnp.linalg.norm(p - 0.5, axis=-1) - 0.3


def tsphere(p):
    return torch.linalg.norm(p - 0.5, dim=-1) - 0.3


def jax_draws(key, shapes):
    """The port's draws from the keys the JAX sampler splits ``key`` into:
    one per shape, in order (a sampler may split off keys it never uses)."""
    keys = jax.random.split(key, len(shapes) + 1)
    return [t(np.asarray(jax.random.uniform(k, s))) for k, s in zip(keys, shapes)]


# ------------------------------------------------------------- VolSDF helpers


def test_volsdf_functions_match_jax(rng):
    """Density, d*, the error bound at a scalar and a per-ray beta, density
    weights and the merge of two sample sets, within 1e-5 (the merge's
    order exactly)."""
    sdf = (rng.randn(3, 5, 9) * 0.2).astype(np.float32)
    starts = np.sort(rng.rand(3, 5, 9).astype(np.float32), -1)
    ends = np.concatenate([starts[..., 1:], starts[..., -1:] + 0.05], -1)
    deltas = np.maximum(ends - starts, 1e-6).astype(np.float32)
    beta = (rng.rand(3, 5, 1) * 0.2 + 0.01).astype(np.float32)
    assert_rel(tsamplers.laplace_density(t(sdf), t(beta)).numpy(),
               jsamplers.laplace_density(jnp.asarray(sdf), jnp.asarray(beta)), 1e-5,
               "density")
    jd = jsamplers.volsdf_dstar(jnp.asarray(sdf), jnp.asarray(deltas))
    td = tsamplers.volsdf_dstar(t(sdf), t(deltas))
    assert_rel(td.numpy(), jd, 1e-5, "d*")
    for b in (0.1, beta):
        assert_rel(tsamplers.volsdf_error_bound(t(np.asarray(b)) if np.ndim(b) else b,
                                                t(sdf), td, t(deltas)).numpy(),
                   jsamplers.volsdf_error_bound(jnp.asarray(b), jnp.asarray(sdf), jd,
                                                jnp.asarray(deltas)), 1e-5, "error bound")
    dens = np.abs(rng.randn(3, 5, 9)).astype(np.float32) * 5
    for tw, jw in zip(trays.get_weights_from_densities(t(dens), t(starts), t(ends)),
                      jrays.get_weights_from_densities(jnp.asarray(dens), jnp.asarray(starts),
                                                       jnp.asarray(ends))):
        assert_rel(tw.numpy(), jw, 1e-5, "density weights")
    s2 = np.sort(rng.rand(3, 5, 4).astype(np.float32), -1)
    e2 = s2 + 0.01
    jout = jrays.merge_ray_samples(*(jnp.asarray(x) for x in (starts, ends, s2, e2)))
    tout = trays.merge_ray_samples(*(t(x) for x in (starts, ends, s2, e2)))
    assert_rel(tout[0].numpy(), jout[0], 1e-5, "merged starts")
    assert_rel(tout[1].numpy(), jout[1], 1e-5, "merged ends")
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))


# ------------------------------------------------------------- samplers

EB = dict(num_samples=6, num_samples_eval=10, num_samples_extra=3, beta_iters=3,
          max_total_iters=3)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_error_bounded_sampler_matches_jax(rng, train):
    """Three rounds over a sphere's sdf: the port's draws are the JAX
    sampler's ``split(rng, rounds + 2)`` uniforms of ``draw_shapes``; starts
    and ends within 1e-5."""
    o, d = rays(rng)
    nears, fars = np.full((2, 6), 0.05, np.float32), np.full((2, 6), 1.2, np.float32)
    js, ts = jsamplers.ErrorBoundedSampler(**EB), tsamplers.ErrorBoundedSampler(**EB)
    key = jax.random.PRNGKey(11)
    jst, jen = jax.jit(lambda *a: js(*a[:2], jsphere, *a[2:], train=train, rng=key))(
        jnp.asarray(nears), jnp.asarray(fars), jnp.asarray(o), jnp.asarray(d))
    shapes = ts.draw_shapes((2, 6))
    assert shapes == ((2, 6, 11), (2, 6, 11), (2, 6, 11), (2, 6, 7))
    draws = jax_draws(key, shapes) if train else None
    tst, ten = ts(t(nears), t(fars), tsphere, t(o), t(d), train=train, draws=draws)
    assert tst.shape == (2, 6, ts.total_samples())
    assert_rel(tst.numpy(), jst, 1e-5, "starts")
    assert_rel(ten.numpy(), jen, 1e-5, "ends")


UNISURF = dict(num_samples_importance=6, num_samples_interval=5, num_marching_steps=24,
               delta=0.05)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_unisurf_sampler_matches_jax(rng, train):
    """Rays that cross the sphere and rays that miss it: the crossing depth
    and mask of ``find_surface`` (the mask exactly), and the samples, within
    1e-5, with the JAX sampler's two draws handed over."""
    o, d = rays(rng, R=8)
    d[0, :3] = [[1, 0, 0]] * 3  # along x from inside the cube: most cross
    o[1, :2] = [[0.05, 0.05, 0.05]] * 2
    d[1, :2] = [[0, 0, 1]] * 2  # along a cube edge: no crossing
    nears, fars = np.full((2, 8), 0.05, np.float32), np.full((2, 8), 1.2, np.float32)
    js, ts = jsamplers.UniSurfSampler(**UNISURF), tsamplers.UniSurfSampler(**UNISURF)
    key = jax.random.PRNGKey(3)
    jst, jen = jax.jit(lambda *a: js(*a[:2], jsphere, *a[2:], train=train, rng=key))(
        jnp.asarray(nears), jnp.asarray(fars), jnp.asarray(o), jnp.asarray(d))
    shapes = ts.draw_shapes((2, 8))
    assert shapes == ((2, 8, 7), (2, 8, 6))
    draws = None
    if train:  # the JAX sampler splits its key in 2, both used
        keys = jax.random.split(key, 2)
        draws = [t(np.asarray(jax.random.uniform(k, s))) for k, s in zip(keys, shapes)]
    tst, ten = ts(t(nears), t(fars), tsphere, t(o), t(d), train=train, draws=draws)
    assert_rel(tst.numpy(), jst, 1e-5, "starts")
    assert_rel(ten.numpy(), jen, 1e-5, "ends")

    m_starts, m_ends = ts.march(t(nears), t(fars))
    pos = trays.sample_positions(t(o), t(d), m_starts, m_ends)
    sdf = tsphere(pos)
    jz, jmask = js.find_surface(jnp.asarray(m_starts.numpy()), jnp.asarray(sdf.numpy()),
                                None, None)
    tz, tmask = ts.find_surface(m_starts, sdf, None, None)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert tmask.numpy().any() and not tmask.numpy().all()
    assert_rel(tz.numpy(), jz, 1e-5, "z")


def test_neus_acc_sampler_is_the_neus_sampler(rng):
    """An alias in both packages: the port's gives the NeuS sampler's samples
    from the same draws, and neither class adds a member of its own."""
    assert set(jsamplers.NeuSAccSampler.__dict__) <= {"__module__", "__doc__", "__qualname__"}
    assert set(tsamplers.NeuSAccSampler.__dict__) <= {"__module__", "__doc__", "__qualname__"}
    o, d = rays(rng)
    nears, fars = torch.full((2, 6), 0.05), torch.full((2, 6), 1.2)
    cfg = dict(num_samples=8, num_samples_importance=4, num_upsample_steps=2)
    acc, neus = tsamplers.NeuSAccSampler(**cfg), tsamplers.NeuSSampler(**cfg)
    gen = torch.Generator().manual_seed(0)
    draws = [torch.rand(s, generator=gen) for s in acc.draw_shapes((2, 6))]
    a = acc(nears, fars, tsphere, t(o), t(d), train=True, draws=draws)
    b = neus(nears, fars, tsphere, t(o), t(d), train=True, draws=draws)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------------------- VolSDFModel

FIELD = dict(hidden_dim=16, num_layers=2, geo_feat_dim=4, semantic_dim=8,
             share_volume=False)
FEATURE_DIM = 6
LOSS = dict(sensor_depth_truncation=0.05, temperature=0.07, val_ray_split=8,
            weights=dict(rgb=10.0, depth=1.0, semantic=0.1, eikonal=0.01,
                         free_space=1.0, sdf=10.0))
# two rounds of the sampler, to keep the JAX compile short
VOLSDF = dict(field=FIELD, collider=dict(type="AABBBoxCollider", near_plane=0.01),
              sampler=dict(type="ErrorBoundedSampler", **dict(
                  EB, num_samples_eval=8, beta_iters=2, max_total_iters=2)), loss=LOSS)


def test_volsdf_render_losses_and_grads_match_jax(rng):
    """A training render of ``VolSDFModel`` with the JAX model's weights (the
    field and the learned Laplace beta through ``_render_model``) and the
    JAX sampler's draws: the render outputs within 1e-5 (the normal on rays
    whose composited gradient has a norm of 0.1 or more: below, normalizing
    scales f32 rounding up), every loss term within 1e-5, and the grads of
    the total with respect to the volume and every parameter within 1e-4
    (the eval path's samplers and losses are held above and in
    ``test_torch_pretrain_ops.py``)."""
    train = True
    B, R, C, K = 2, 12, 8, 6
    vol = rng.randn(B, FEATURE_DIM, 5, 6, 4).astype(np.float32)
    o, d = rays(rng, B, R)
    depth = (rng.rand(B, R) - 0.15).astype(np.float32)
    targets = dict(rgb=rng.rand(B, R, 3).astype(np.float32), depth=depth,
                   semantic=rng.randint(-1, K, (B, R)).astype(np.int32), ray_mask=depth > 0)
    emb = rng.randn(K, C).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    key = jax.random.PRNGKey(2)

    jm = JVolSDFModel(**VOLSDF)
    # the parameters' shapes from a trace (no compile), values from a seed:
    # kernels at 1/sqrt(fan-in), the rest small; the Laplace beta off its init
    shapes = jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a, train, key),
                            jnp.asarray(vol), jnp.asarray(o), jnp.asarray(d))["params"]
    wrng = np.random.RandomState(4)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (wrng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
                            if "kernel" in str(path[-1])
                            else wrng.uniform(-0.1, 0.1, leaf.shape)).astype(np.float32),
        shapes)
    params["field"]["deviation_network"]["variance"] = np.float32(0.3)
    params["laplace_density"]["beta"] = np.float32(0.07)

    def jfn(p, v):
        out = jm.apply({"params": p}, v, jnp.asarray(o), jnp.asarray(d), train, key)
        losses = jm.apply({"params": p}, out, {k: jnp.asarray(x) for k, x in targets.items()},
                          jnp.asarray(emb), train, method=JVolSDFModel.get_loss)
        return losses["render_loss"], (out, losses)

    (_, (jout, jl)), (jgp, jgv) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(params, jnp.asarray(vol))

    tm = RENDERERS.build(dict(type="VolSDFModel", feature_dim=FEATURE_DIM, **VOLSDF))
    assert isinstance(tm, VolSDFModel)
    sd = {}
    _render_model(sd, "renderer", params)
    tm.load_state_dict({k[len("renderer."):]: t(v) for k, v in sd.items()})
    assert float(tm.laplace_density.beta) == np.float32(0.07)
    draws = jax_draws(key, tm.draw_shapes((B, R))) if train else None
    v = t(vol).requires_grad_()
    vol_cl = tm.field.volume_channels_last(v)
    out = tm(vol_cl, t(o), t(d), draws=draws)
    for k in ("weights", "sdf", "gradients", "sample_depths", "depth", "accumulation",
              "rgb", "semantic"):
        assert_rel(out[k].detach().numpy(), jout[k], 1e-5, k)
    n = (out["weights"][..., None] * out["gradients"]).sum(-2).norm(dim=-1).detach()
    well = (n >= 0.1).numpy()
    assert well.sum() >= B * R // 2
    assert_rel(out["normal"].detach().numpy()[well], np.asarray(jout["normal"])[well],
               1e-5, "normal")
    tl = tm.get_loss(out, {k: t(x) for k, x in targets.items()}, t(emb), train)
    assert sorted(tl) == sorted(jl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    tl["render_loss"].backward()
    assert_rel(v.grad.numpy(), jgv, 1e-4, "d volume")
    gsd = {}
    _render_model(gsd, "renderer", jax.device_get(jgp))
    top = max(np.abs(g).max() for g in gsd.values())
    for name, p in tm.named_parameters():
        ref = np.asarray(gsd["renderer." + name])
        # a grad below 1e-4 of the largest one (zero by construction up to
        # f32 cancellation) is held to 1e-4 of the largest
        scale = top if np.abs(ref).max() < 1e-4 * top else np.abs(ref).max()
        grad = np.zeros_like(ref) if p.grad is None else p.grad.numpy()  # unused: zero
        err = np.abs(grad - ref).max()
        assert err <= 1e-4 * scale, (name, err, scale)
