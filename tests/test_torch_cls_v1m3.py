"""PyTorch port vs JAX package: SpUNet-v1m3 in ``cls_mode`` on the CPU.

One stage of one block (so that the JAX compile stays small), with and
without a ``final`` classifier: the JAX model's variables (scanned blocks,
drawn from a seed; ``final`` a flax Dense) go through the port's converter
(``utils/convert.py:state_dict_from_jax_spunet_v1m3``) into the port's
model, which must take them whole; then an eval forward of two scenes under
one condition and context. Tolerance: the pooled features or logits within
1e-5 of max|ref| (sums in another order); the port's contract flag true.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ponderv2_tpu.models import build_model as jbuild
from ponderv2_tpu.ops.sparse import make_sparse_tensor
from ponderv2_tpu_torch.datasets import build_dataset, collate_fn
from ponderv2_tpu_torch.models import build_model as tbuild
from ponderv2_tpu_torch.models.default import batch_to_sparse_tensor
from ponderv2_tpu_torch.utils.convert import state_dict_from_jax_spunet_v1m3
from jax_compile import jit  # noqa: E402
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)

SHAPE = (160, 160, 64)
CONDITIONS = ("ScanNet", "S3DIS", "Structured3D")


@pytest.fixture(autouse=True)
def _torch_state():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


def cls_cfg(num_classes):
    return dict(type="SpUNet-v1m3", in_channels=6, num_classes=num_classes, base_channels=16,
                channels=(24, 24), layers=(1, 1), cls_mode=True, conditions=CONDITIONS,
                context_channels=16)


def two_scenes():
    ds = build_dataset(dict(
        type="SyntheticDataset", num_scenes=2, points_per_scene=1000, num_classes=20,
        transform=[dict(type="CenterShift", apply_z=True),
                   dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="train",
                        return_grid_coord=True),
                   dict(type="NormalizeColor"),
                   dict(type="Collect", keys=("coord", "grid_coord"),
                        feat_keys=("color", "normal"))]))
    state = np.random.get_state()
    np.random.seed(0)  # GridSample's draw
    try:
        return collate_fn([ds[0], ds[1]], point_budget=2048, scene_budget=2)
    finally:
        np.random.set_state(state)


@pytest.fixture(scope="module")
def jax_pooled():
    """The JAX v1m3's pooled features (no ``final``) of ``two_scenes`` under
    one condition and context, with its variables drawn from a seed: the
    shapes from a trace (no compile), kernels at 1/sqrt(fan-in), BN scales,
    biases and statistics off their init so that each condition's norm
    counts. One compile serves both cases."""
    batch = two_scenes()
    coords = np.concatenate([batch["batch"][:, None], batch["grid_coord"]], 1).astype(np.int32)
    st = make_sparse_tensor(jnp.asarray(batch["feat"]), jnp.asarray(coords), SHAPE, 2)
    context = np.random.RandomState(1).randn(16).astype(np.float32)
    jmodel = jbuild(dict(cls_cfg(0), remat=False))
    shapes = jax.eval_shape(lambda s, ctx: jmodel.init(
        jax.random.PRNGKey(0), s, train=False, condition="S3DIS", context=ctx),
        st, jnp.asarray(context))
    rng = np.random.RandomState(2)

    def draw(path, leaf):
        name, shape = str(path[-1]), leaf.shape
        if "kernel" in name:
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif "scale" in name or "var" in name:
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.uniform(-0.2, 0.2, shape)
        return v.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(draw, shapes["batch_stats"])

    @jit
    def fwd(p, s, sparse, ctx):
        return jmodel.apply({"params": p, "batch_stats": s}, sparse, train=False,
                            condition="S3DIS", context=ctx)

    pooled = np.asarray(fwd(params, stats, st, jnp.asarray(context)))
    return batch, context, params, stats, pooled


@pytest.mark.parametrize("num_classes", [0, 5], ids=["no_final", "final"])
def test_spunet_v1m3_cls_mode_matches_jax(jax_pooled, num_classes):
    """With ``final`` the reference is the JAX model's own last layer, a
    flax ``Dense(num_classes)`` on the pooled features, under the name
    ``final`` that the JAX v1m3 gives it."""
    import flax.linen as fnn

    batch, context, params, stats, ref = jax_pooled
    assert ref.shape == (2, 24)
    if num_classes:
        rng = np.random.RandomState(3)
        final = {"kernel": (rng.randn(24, num_classes) / np.sqrt(24)).astype(np.float32),
                 "bias": rng.uniform(-0.2, 0.2, num_classes).astype(np.float32)}
        params = dict(params, final=final)
        ref = np.asarray(fnn.Dense(num_classes).apply({"params": final}, jnp.asarray(ref)))

    model = tbuild(cls_cfg(num_classes)).eval()
    assert (model.final is None) == (num_classes == 0)
    assert not hasattr(model, "up") and not hasattr(model, "dec")
    sd = state_dict_from_jax_spunet_v1m3(params, stats, (1, 1), CONDITIONS)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    tst = batch_to_sparse_tensor({"feat": torch.from_numpy(batch["feat"]),
                                  "grid_coord": torch.from_numpy(batch["grid_coord"]),
                                  "batch": torch.from_numpy(batch["batch"]),
                                  "spatial_shape": SHAPE, "batch_size": 2})
    with torch.inference_mode():
        out, ok = model(tst, condition="S3DIS", context=torch.from_numpy(context))
    assert bool(ok)
    assert out.shape == ref.shape
    err = np.abs(out.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), (err, np.abs(ref).max())
