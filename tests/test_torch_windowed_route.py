"""PyTorch port vs JAX package: the windowed gather conv route.

With ``PONDER_WINDOWED_GATHER`` set, a gather conv of at least 4096 output
rows and at most 128 channels either side runs the windowed form. The JAX
package's is XLA (``ponderv2_tpu/ops/spconv.py:930-1121``); the port's runs
K4 / K5 (here on the CPU, their plain versions) plus a residual for the
entries outside their windows. Held here: ``use_windowed_gather`` and
``windowed_coverage`` equal to JAX's; ``apply_sparse_conv_windowed``, the
windowed ``subm_conv_symmetric`` and the strided / inverse rulebook convs
(``layers._apply_conv``) against JAX's, outputs and grads, within 1e-5 of
max|ref| in f32 and 3e-2 in bf16, on a rulebook whose entries all fall in
their windows and on one whose rows are shuffled (most outside); and the
routing: only a ``plain`` SubMConv (and a strided / inverse conv over a
rulebook) takes the route, never the ``slab`` or band routes.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import ponderv2_tpu.ops.spconv as jsp
from ponderv2_tpu.models.sparse_unet import layers as jlayers
from ponderv2_tpu_torch.models import build_model
from ponderv2_tpu_torch.models.sparse_unet import layers as tlayers
from ponderv2_tpu_torch.models.sparse_unet.layers import SubMConv
from ponderv2_tpu_torch.ops import spconv as tsp
from ponderv2_tpu_torch.ops.sparse import make_sparse_tensor
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)

SHAPE = (48, 48, 16)
F32, BF16 = 1e-5, 3e-2
CIN, COUT = 8, 12


@pytest.fixture(autouse=True)
def _torch_state():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


@pytest.fixture
def windowed(monkeypatch):
    monkeypatch.setenv("PONDER_WINDOWED_GATHER", "1")


def scene(seed=0, n=7000, shape=SHAPE):
    """Unique voxels of two scenes sorted by key, then 40 padding rows:
    (coords (N, 4) int32, mask (N,))."""
    rng = np.random.RandomState(seed)
    c = np.stack([rng.randint(0, 2, n), rng.randint(0, shape[0], n),
                  rng.randint(0, shape[1], n), rng.randint(0, shape[2], n)], 1)
    c = np.unique(c, axis=0)
    c = np.concatenate([c, np.full((40, 4), -1)]).astype(np.int32)
    return c, c[:, 0] >= 0


def shuffled(rb, n, seed=1, mask=None):
    """The rulebook over the same rows in a random order: most entries land
    outside their windows. With ``mask`` the output rows are relabelled too
    (a subm rulebook stays mirror-symmetric), and the mask with them."""
    perm = np.random.RandomState(seed).permutation(n).astype(np.int32)
    out = np.where(rb >= 0, perm[np.maximum(rb, 0)], -1).astype(np.int32)
    if mask is None:
        return out
    inv = np.argsort(perm)
    return out[:, inv], mask[inv]


def subm_rulebook(coords, k=3):
    return tsp.build_subm_rulebook(torch.from_numpy(coords), SHAPE, 2, k).numpy()


def assert_rel(got, ref, bound, where):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, where
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= bound * scale, f"{where}: err {err:.3e} vs {bound} x {scale:.3e}"


@pytest.mark.parametrize("flag", [None, "0", "1"], ids=["unset", "0", "1"])
def test_use_windowed_gather_matches_jax(monkeypatch, flag):
    if flag is None:
        monkeypatch.delenv("PONDER_WINDOWED_GATHER", raising=False)
    else:
        monkeypatch.setenv("PONDER_WINDOWED_GATHER", flag)
    for n_out in (4095, 4096):
        for cin, cout in ((128, 128), (129, 32), (32, 256)):
            got = tsp.use_windowed_gather(n_out, cin, cout)
            assert got == jsp.use_windowed_gather(n_out, cin, cout)
            assert got == (flag == "1" and n_out == 4096 and (cin, cout) == (128, 128))


def test_windowed_coverage_and_geometry_match_jax():
    """``_window_geometry`` integer-equal to JAX's and ``windowed_coverage``
    equal, on a monotone rulebook (every block covered) and on a shuffled
    one, at the default window and at a narrow one."""
    coords, _ = scene()
    n = len(coords)
    rb = subm_rulebook(coords)
    for r in (rb, shuffled(rb, n)):
        for window, block in ((1024, 512), (64, 64)):
            jg = jsp._window_geometry(jnp.asarray(r), n, window, block)
            tg = tsp._window_geometry(torch.from_numpy(r), n, window, block)
            for a, b in zip(jg, tg):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
            assert (float(tsp.windowed_coverage(torch.from_numpy(r), n, window, block))
                    == float(jsp.windowed_coverage(jnp.asarray(r), n, window, block)))
    assert float(tsp.windowed_coverage(torch.from_numpy(rb), n)) == 1.0
    assert float(tsp.windowed_coverage(torch.from_numpy(shuffled(rb, n)), n)) < 0.5


@jax.jit
def _jax_windowed(f, rb, w, mask, token):
    return jsp.apply_sparse_conv_windowed(f, rb, w, mask, token.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ["covered", "shuffled"])
def test_apply_sparse_conv_windowed_matches_jax(order, dtype):
    """The windowed forward of a k3 rulebook in both packages; the port's
    counts: every entry inside its window when the rows are in order, most
    outside (taken by the residual) when shuffled."""
    coords, mask = scene()
    n = len(coords)
    rb = subm_rulebook(coords)
    if order == "shuffled":
        rb = shuffled(rb, n)
    rng = np.random.RandomState(2)
    f = rng.randn(n, CIN).astype(np.float32) * mask[:, None]
    w = (rng.randn(27, CIN, COUT) / (27 * CIN) ** 0.5).astype(np.float32)
    route = tsp.windowed_route(torch.from_numpy(rb), n)
    inside, live = int(route.inside), int(route.live)
    assert live == int((rb >= 0).sum())
    assert (inside == live) if order == "covered" else (inside < live // 2)
    got = tsp.apply_sparse_conv_windowed(torch.from_numpy(f), torch.from_numpy(rb),
                                         torch.from_numpy(w), torch.from_numpy(mask),
                                         getattr(torch, dtype), route)
    ref = _jax_windowed(jnp.asarray(f), jnp.asarray(rb), jnp.asarray(w),
                        jnp.asarray(mask), jnp.zeros((0,), getattr(jnp, dtype)))
    assert got.dtype == torch.float32
    assert_rel(got.numpy(), ref, F32 if dtype == "float32" else BF16, f"{order} {dtype}")


@pytest.fixture(scope="module")
def jax_subm_grads():
    """JAX's windowed ``subm_conv_symmetric``: output, dx and dW of
    sum(out * cos(out)) on a covered rulebook and on one with its rows
    relabelled by a permutation (still mirror-symmetric), in f32 and bf16
    (``tests/test_spconv.py::test_full_vjp_windowed_branch``, with the
    switch set)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PONDER_WINDOWED_GATHER", "1")
    coords, mask = scene(3)
    n = len(coords)
    rb = subm_rulebook(coords)
    rng = np.random.RandomState(4)
    f = rng.randn(n, CIN).astype(np.float32) * mask[:, None]
    w = (rng.randn(27, CIN, COUT) / (27 * CIN) ** 0.5).astype(np.float32)

    def loss(f_, w_, rb_, mask_, token):
        out = jsp.subm_conv_symmetric(f_, rb_, w_, mask_, token)
        return jnp.sum(out * jnp.cos(out)), out

    grad = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))
    out = {}
    try:
        for order, (r, m) in (("covered", (rb, mask)),
                              ("shuffled", shuffled(rb, n, mask=mask))):
            for dtype in ("float32", "bfloat16"):
                (dx, dw), o = grad(jnp.asarray(f), jnp.asarray(w), jnp.asarray(r),
                                   jnp.asarray(m), jnp.zeros((0,), getattr(jnp, dtype)))
                out[order, dtype] = (r, m, np.asarray(o), np.asarray(dx), np.asarray(dw))
    finally:
        mp.undo()
    return f, w, out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ["covered", "shuffled"])
def test_subm_conv_symmetric_windowed_matches_jax(windowed, jax_subm_grads, order, dtype):
    """Output, dx and dW of the windowed subm conv (K4 forward, dx by the
    forward of g with the mirrored, transposed weights, dW by K5, each with
    its residual) against JAX's windowed branch."""
    f, w, ref = jax_subm_grads
    rb, mask, out_r, dx_r, dw_r = ref[order, dtype]
    x = torch.from_numpy(f).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = tsp.subm_conv_symmetric(x, torch.from_numpy(rb), wt, torch.from_numpy(mask),
                                  getattr(torch, dtype))
    dx, dw = torch.autograd.grad((out * torch.cos(out)).sum(), (x, wt))
    bound = F32 if dtype == "float32" else BF16
    for name, got, r in (("out", out, out_r), ("dx", dx, dx_r), ("dW", dw, dw_r)):
        assert_rel(got.detach().numpy(), r, bound, f"{order} {dtype} {name}")


def _coarse_plan(seed):
    """A strided k2s2 rulebook with over 4096 coarse rows (its fine voxels
    spread over a (96, 96, 32) grid) and the paired inverse rulebook."""
    shape = (96, 96, 32)
    rng = np.random.RandomState(seed)
    c = np.unique(np.stack([np.zeros(6000, int), rng.randint(0, 96, 6000),
                            rng.randint(0, 96, 6000), rng.randint(0, 32, 6000)], 1), axis=0)
    c = np.concatenate([c, np.full((24, 4), -1)]).astype(np.int32)
    plan = tsp.build_strided_plan(torch.from_numpy(c), shape, 1, 2, 2, 0, len(c))
    inv = tsp.invert_strided_rulebook(plan.rulebook, len(c))
    return c, plan, inv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["strided", "inverse"])
def test_strided_and_inverse_windowed_match_jax(windowed, kind, dtype):
    """The strided conv and the inverse conv over rulebooks (k2s2, 8 taps
    in groups of 4), through ``layers._apply_conv`` of both packages with
    the switch set: output, dx and dW of sum(out * cos(out)) against JAX's
    autodiff of its windowed form; the port's dx is the rulebook backward,
    its dW K5's plus the residual's."""
    fine, plan, inv = _coarse_plan(5)
    fine_mask = fine[:, 0] >= 0
    coarse_mask = (plan.out_coords[:, 0] >= 0).numpy()
    rng = np.random.RandomState(6)
    if kind == "strided":
        rb, n_in, in_mask, out_mask = plan.rulebook.numpy(), len(fine), fine_mask, coarse_mask
    else:
        rb, n_in, in_mask, out_mask = inv.numpy(), len(coarse_mask), coarse_mask, fine_mask
    assert rb.shape[1] >= 4096 and tsp.use_windowed_gather(rb.shape[1], CIN, COUT)
    f = rng.randn(n_in, CIN).astype(np.float32) * in_mask[:, None]
    w = (rng.randn(8, CIN, COUT) / (8 * CIN) ** 0.5).astype(np.float32)

    def jloss(f_, w_):
        out = jlayers._apply_conv(f_, jnp.asarray(rb), w_, jnp.asarray(out_mask),
                                  getattr(jnp, dtype))
        return jnp.sum(out * jnp.cos(out)), out

    (jdx, jdw), jout = jax.jit(jax.grad(jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(f), jnp.asarray(w))
    x = torch.from_numpy(f).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out, counts = tlayers._apply_conv(x, torch.from_numpy(rb), wt,
                                      torch.from_numpy(out_mask), getattr(torch, dtype))
    assert counts is not None and int(counts[1]) == int((rb >= 0).sum())
    dx, dw = torch.autograd.grad((out * torch.cos(out)).sum(), (x, wt))
    bound = F32 if dtype == "float32" else BF16
    for name, got, r in (("out", out, jout), ("dx", dx, jdx), ("dW", dw, jdw)):
        assert_rel(got.detach().numpy(), np.asarray(r), bound, f"{kind} {dtype} {name}")


def test_routes_take_the_windowed_route_only_where_jax_does(windowed):
    """With the switch set: SpUNet-v1m1 on SubmPlan levels runs its k5 stem
    on the ``slab`` route and every k3 conv on a band route, none windowed;
    a SubMConv over a plain rulebook of at most 128 channels takes the
    ``windowed`` route (counting its entries) and gives the plain route's
    output, one over 128 channels stays ``plain``, and one of 65-128
    channels with a band plan takes the band route."""
    coords, mask = scene(7)
    n = len(coords)
    model = build_model(dict(type="SpUNet-v1m1", in_channels=4, num_classes=3,
                             base_channels=8, channels=(8, 16, 16, 8),
                             layers=(1, 1, 1, 1), remat=False)).eval()
    feats = torch.from_numpy(np.random.RandomState(8).randn(n, 4).astype(np.float32))
    st = make_sparse_tensor(feats, torch.from_numpy(coords), SHAPE, 2)
    with torch.no_grad():
        model(st)
    routes = [m.last_route for m in model.modules() if isinstance(m, SubMConv)]
    assert routes[0] == "slab" and set(routes[1:]) == {"band-attached"}
    assert all(m.last_window is None for m in model.modules() if hasattr(m, "last_window"))

    rb = tsp.build_subm_rulebook(st.coords, SHAPE, 2, 3)
    x = make_sparse_tensor(torch.randn(n, 16), st.coords, SHAPE, 2)
    conv = SubMConv(16, 16, 3)
    with torch.no_grad():
        got = conv(x, rb).features
        ref = tsp.apply_sparse_conv(x.features, rb, conv.taps(), x.mask)
    assert conv.last_route == "windowed"
    inside, live = (int(c) for c in conv.last_window)
    assert inside == live == int((rb >= 0).sum())
    assert_rel(got.numpy(), ref.numpy(), F32, "windowed SubMConv")
    wide = SubMConv(130, 16, 5)
    with torch.no_grad():
        wide(make_sparse_tensor(torch.randn(n, 130), st.coords, SHAPE, 2),
             tsp.build_subm_rulebook(st.coords, SHAPE, 2, 5))
    assert wide.last_route == "plain" and wide.last_window is None
    banded = SubMConv(96, 96, 3)
    with torch.no_grad():
        banded(make_sparse_tensor(torch.randn(n, 96), st.coords, SHAPE, 2), rb)
    assert banded.last_route == "band-inline"


def test_windowed_route_is_built_once_per_rulebook(windowed, monkeypatch):
    """``windowed_route`` hands back the route built for a rulebook while
    the rulebook lives and is not modified in place, as the convs over one
    rulebook (a level's blocks, the remat recompute) take it; another
    rulebook or an in-place change builds anew, and a freed rulebook's
    route leaves the cache. With the switch set, ``subm_conv_symmetric``
    takes the cached route and ``subm_conv_gather`` (the slab route's
    function) runs neither K4 nor K5."""
    import gc

    from ponderv2_tpu_torch.ops import windowed_gather as wg

    coords, mask = scene(9)
    n = len(coords)
    rb = torch.from_numpy(subm_rulebook(coords))
    first = tsp.windowed_route(rb, n)
    assert tsp.windowed_route(rb, n) is first
    assert tsp.windowed_route(rb.clone(), n) is not first
    built = []
    build = tsp.build_windowed_route
    monkeypatch.setattr(tsp, "build_windowed_route",
                        lambda *a: built.append(1) or build(*a))
    x = torch.randn(n, CIN) * torch.from_numpy(mask)[:, None]
    w = torch.randn(27, CIN, COUT) / (27 * CIN) ** 0.5
    out = tsp.subm_conv_symmetric(x, rb, w, torch.from_numpy(mask))
    assert built == []
    ref = tsp.apply_sparse_conv(x, rb, w, torch.from_numpy(mask))
    assert_rel(out.numpy(), ref.numpy(), F32, "cached route")
    monkeypatch.setattr(wg, "windowed_conv_fwd", None)
    monkeypatch.setattr(wg, "windowed_conv_dw", None)
    xg, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
    gathered = tsp.subm_conv_gather(xg, rb, wt, torch.from_numpy(mask))
    torch.autograd.grad(gathered.sum(), (xg, wt))
    assert torch.equal(gathered.detach(), ref)
    rb[0, 0] = rb[0, 0]  # an in-place write moves the version counter
    again = tsp.windowed_route(rb, n)
    assert built == [1] and again is not first and tsp.windowed_route(rb, n) is again
    key = (id(rb), n)
    assert key in tsp._ROUTES
    del rb, first, again, gathered  # the graph's ctx holds the rulebook
    gc.collect()
    assert key not in tsp._ROUTES
