"""PyTorch port vs JAX package: masked BN, weight conversion, conv routing."""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_torch_checkpoint import convert_spunet_v1m1  # noqa: E402

from ponderv2_tpu.models.norm import MaskedBatchNorm as JBN  # noqa: E402
from ponderv2_tpu.models.sparse_unet import plans as jplans  # noqa: E402
from ponderv2_tpu.ops import band_conv as jbc  # noqa: E402
from ponderv2_tpu.ops import spconv as jsp  # noqa: E402
from ponderv2_tpu_torch.models import build_model  # noqa: E402
from ponderv2_tpu_torch.models.norm import MaskedBatchNorm as TBN  # noqa: E402
from ponderv2_tpu_torch.ops import band_conv as tbc  # noqa: E402
from ponderv2_tpu_torch.ops.sparse import make_sparse_tensor  # noqa: E402
from ponderv2_tpu_torch.utils.convert import state_dict_from_jax_spunet  # noqa: E402
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)


@pytest.fixture(autouse=True)
def _torch_state():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


class TestMaskedBatchNorm:
    @pytest.mark.parametrize("train", [True, False])
    def test_matches_jax(self, rng, train):
        n, c = 50, 7
        x = (rng.randn(n, c) * 3 + 1).astype(np.float32)
        mask = rng.rand(n) > 0.3
        scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
        bias = rng.uniform(-0.5, 0.5, c).astype(np.float32)
        mean = rng.uniform(-0.5, 0.5, c).astype(np.float32)
        var = rng.uniform(0.5, 2.0, c).astype(np.float32)
        jbn = JBN(c, 1e-3, 0.01)
        variables = {"params": {"scale": scale, "bias": bias},
                     "batch_stats": {"mean": mean, "var": var}}
        ref, upd = jbn.apply(variables, jnp.asarray(x), jnp.asarray(mask), train,
                             mutable=["batch_stats"])
        tbn = TBN(c, 1e-3, 0.01)
        with torch.no_grad():
            for name, v in [("weight", scale), ("bias", bias),
                            ("running_mean", mean), ("running_var", var)]:
                getattr(tbn, name).copy_(torch.from_numpy(v))
        tbn.train(train)
        with torch.no_grad():
            out = tbn(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
        # f32 reductions over 50 rows, summed in another order
        np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-5)
        assert np.abs(out[~mask]).sum() == 0.0
        np.testing.assert_allclose(tbn.running_mean.numpy(),
                                   np.asarray(upd["batch_stats"]["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tbn.running_var.numpy(),
                                   np.asarray(upd["batch_stats"]["var"]),
                                   rtol=1e-5, atol=1e-6)


def _small_spunet(layers):
    return build_model(dict(
        type="SpUNet-v1m1", in_channels=6, num_classes=5, base_channels=8,
        channels=(8, 16, 16, 16, 16, 16, 8, 8), layers=layers))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


class TestConverter:
    @pytest.mark.parametrize("layers", [(1,) * 8, (1, 2, 1, 3, 2, 1, 3, 1)])
    def test_round_trip(self, layers):
        """``convert_spunet_v1m1`` (torch -> JAX, the JAX package's tool) and
        ``state_dict_from_jax_spunet`` (JAX -> torch) invert each other leaf
        for leaf, and the port's own state_dict is the reference one."""
        channels = (8, 16, 16, 16, 16, 16, 8, 8)
        model = _small_spunet(layers)
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        params, stats = convert_spunet_v1m1(sd, channels, layers)
        back = state_dict_from_jax_spunet(params, stats, channels, layers)
        assert sorted(back) == sorted(sd)
        for k in sd:
            assert back[k].shape == sd[k].shape, k
            np.testing.assert_array_equal(back[k], sd[k])
        params2, stats2 = convert_spunet_v1m1(back, channels, layers)
        for tree, tree2 in [(params, params2), (stats, stats2)]:
            l1, l2 = list(_leaves(tree)), list(_leaves(tree2))
            assert [p for p, _ in l1] == [p for p, _ in l2]
            for (path, a), (_, b) in zip(l1, l2):
                assert a.shape == b.shape, path
                np.testing.assert_array_equal(a, b)
        model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in back.items()})


# the slice's model: configs/scannet/semseg-spunet-v1m1-0-base.py
SLICE = dict(in_channels=9, base_channels=32,
             channels=(32, 64, 128, 256, 256, 128, 96, 96),
             layers=(2, 3, 4, 6, 2, 2, 2, 2))
SCANNET_SHAPE = (1024, 1024, 512)


def _execution_convs(channels, layers, base, in_ch):
    """(level, cin, cout, kernel) of every subm conv, in forward order."""
    ns = len(layers) // 2
    convs = [(0, in_ch, base, 5)]
    for s in range(ns):
        convs += [(s + 1, channels[s], channels[s], 3)] * (2 * layers[s])
    enc = [base] + list(channels[:ns])
    for s in range(ns):
        level, dec = ns - 1 - s, channels[ns + s]
        convs += [(level, dec + enc[level], dec, 3), (level, dec, dec, 3)]
        convs += [(level, dec, dec, 3)] * (2 * (layers[ns + s] - 1))
    return convs


def _jax_route(rb, cin, cout, kernel):
    """The JAX package's SubMConv routing (layers.py:88-123)."""
    legacy = getattr(rb, "legacy", rb)
    band = getattr(rb, "band", None)
    if jbc.band_eligible(cin, cout, kernel):
        if band is not None:
            return "band-attached"
        if legacy is not None and cin > 64:
            return "band-inline"
    if isinstance(rb, jsp.SubmPlan) and cin <= 64:
        return "slab"
    return "plain"


def test_routing_matches_jax_rules(rng):
    """Per subm conv of the slice's SpUNet at ScanNet's sparse_shape, the
    route the port takes equals the one the JAX rules give on JAX plans of
    the same coords: the k5 stem plain, L0's 4 decoder convs band-inline
    (plain L0 rulebook, cin > 64), every k3 conv of L1-L4 band-attached."""
    coords = np.unique(np.stack([np.zeros(400, int), rng.randint(0, 40, 400),
                                 rng.randint(0, 40, 400), rng.randint(0, 12, 400)],
                                1), axis=0).astype(np.int32)
    cap = 512
    coords = np.concatenate([coords, np.full((cap - len(coords), 4), -1, np.int32)])
    caps = (cap, 1024, 1024, 1024, 1024)
    ch, layers = SLICE["channels"], SLICE["layers"]
    build = jax.jit(jplans.build_spunet_plans, static_argnums=(1, 2, 3, 4))
    jp = build(jnp.asarray(coords), SCANNET_SHAPE, 1, caps, ch)
    level_rb = [jp.l0] + list(jp.subm)
    expected = []
    for i, (level, cin, cout, k) in enumerate(_execution_convs(
            ch, layers, SLICE["base_channels"], SLICE["in_channels"])):
        rb = jp.stem if i == 0 else level_rb[level]
        expected.append(_jax_route(rb, cin, cout, k))
        # no TPU VMEM estimate refuses a width of the slice
        assert tbc.band_eligible(cin, cout, k) == jbc.band_eligible(cin, cout, k)

    model = build_model(dict(type="SpUNet-v1m1", num_classes=20, capacities=caps,
                             **SLICE)).eval()
    feats = torch.from_numpy(rng.randn(cap, 9).astype(np.float32))
    st = make_sparse_tensor(feats, torch.from_numpy(coords), SCANNET_SHAPE, 1)
    with torch.inference_mode():
        _, contract_ok = model(st)
    assert bool(contract_ok)
    ns = len(layers) // 2
    convs = [model.conv_input[0]]
    for s in range(ns):
        convs += [c for b in model.enc[s].values() for c in (b.conv1, b.conv2)]
    for s in range(ns):
        convs += [c for b in model.dec[ns - 1 - s].values()
                  for c in (b.conv1, b.conv2)]
    routes = [c.last_route for c in convs]
    assert routes == expected
    assert routes.count("band-attached") == 42
    assert routes.count("band-inline") == 4
    assert routes[0] == "plain"
