"""PyTorch port vs JAX package: a small full DefaultSegmentor forward.

SpUNet-v1m1 at base 16, channels (16, 32, 64, 96, 96, 64, 48, 72), one
block per stage, on a ~3k-point synthetic scene. With sparse_shape
(160, 160, 64) every level is in the dense-grid regime: the stem runs the
slab route (plain gather in the port) and every k3 conv the band conv on an
attached plan. ``test_torch_segmentor_legacy.py`` runs ScanNet's shape.
Weights are the port's, randomized from a seed (BN included), and reach JAX
through the JAX package's own converter. Tolerance 1e-4: 17 convs with BN
in f32, each summed in another order than XLA's.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_torch_checkpoint import convert_spunet_v1m1  # noqa: E402

from ponderv2_tpu.models import build_model as jbuild  # noqa: E402
from ponderv2_tpu_torch.datasets import build_dataset, collate_fn  # noqa: E402
from ponderv2_tpu_torch.models import build_model as tbuild  # noqa: E402
from ponderv2_tpu_torch.models.sparse_unet.layers import SubMConv  # noqa: E402
from jax_compile import background_compile  # noqa: E402
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)

BACKBONE = dict(type="SpUNet-v1m1", in_channels=9, num_classes=20,
                base_channels=16, channels=(16, 32, 64, 96, 96, 64, 48, 72),
                layers=(1,) * 8)
SEGMENTOR = dict(type="DefaultSegmentor", backbone=BACKBONE)


@pytest.fixture(autouse=True)
def _torch_state():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


def synthetic_batch():
    """One ~3k-point synthetic scene, voxelized at 5 cm, collated to 4096."""
    ds = build_dataset(dict(
        type="SyntheticDataset", num_scenes=1, points_per_scene=3000,
        num_classes=20, transform=[
            dict(type="CenterShift", apply_z=True),
            dict(type="NormalizeColor"),
            dict(type="GridSample", grid_size=0.05, hash_type="fnv",
                 mode="train", return_grid_coord=True),
            dict(type="CenterShift", apply_z=False),
            dict(type="Collect", keys=("coord", "grid_coord"),
                 feat_keys=("color", "normal", "coord"))]))
    state = np.random.get_state()
    np.random.seed(0)  # GridSample's train-mode draw
    try:
        batch = collate_fn([ds[0]], point_budget=4096, scene_budget=1)
    finally:
        np.random.set_state(state)
    return {k: batch[k] for k in ("feat", "grid_coord", "batch")}


def seeded_port_model():
    model = tbuild(dict(SEGMENTOR)).eval()
    model.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for name, buf in model.named_parameters():
            if name.endswith(".bias") and "final" not in name:
                buf.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, buf.shape)))
            elif buf.ndim == 1 and "final" not in name:  # BN scale
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape)))
        for name, buf in model.named_buffers():
            lo, hi = (-0.2, 0.2) if name.endswith("running_mean") else (0.5, 2.0)
            buf.copy_(torch.from_numpy(rng.uniform(lo, hi, buf.shape)))
    return model


def run_case(spatial_shape):
    """Both forwards on the same batch and weights. Returns (jax logits,
    jax contract_ok, port logits, port contract_ok, port routes)."""
    arrays = synthetic_batch()
    ctx = dict(spatial_shape=spatial_shape, batch_size=1)
    model = seeded_port_model()
    sd = {k[len("backbone."):]: v.numpy() for k, v in model.state_dict().items()}
    params, stats = convert_spunet_v1m1(sd, BACKBONE["channels"],
                                        BACKBONE["layers"])
    variables = {"params": {"backbone_net": params},
                 "batch_stats": {"backbone_net": stats}}
    jmodel = jbuild(dict(SEGMENTOR))

    @jax.jit
    def fwd(v, a):
        return jmodel.apply(v, {**a, **ctx}, train=False, mutable=["diagnostics"])

    jarrays = {k: jnp.asarray(v) for k, v in arrays.items()}
    fwd = background_compile(fwd, variables, jarrays)  # compiles while the port runs
    with torch.inference_mode():
        tout = model({**{k: torch.from_numpy(v) for k, v in arrays.items()},
                      **ctx})
    out, diag = fwd.result()(variables, jarrays)
    j_ok = bool(jax.tree.leaves(diag["diagnostics"])[0])
    routes = [m.last_route for m in model.modules() if isinstance(m, SubMConv)]
    return (np.asarray(out["seg_logits"]), j_ok, tout["seg_logits"].numpy(),
            bool(tout["contract_ok"]), routes)


def test_segmentor_forward_dense_levels():
    ref, j_ok, out, t_ok, routes = run_case((160, 160, 64))
    assert j_ok and t_ok
    assert np.abs(ref).max() > 0.3  # seeded BN keeps the logits O(1)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    assert routes[0] == "slab"
    assert routes[1:] == ["band-attached"] * 16
