"""PyTorch port vs JAX package: PPT-v1m2 logits and loss on the CPU.

PPT-v1m1's logits and loss are held in ``test_torch_ppt_train.py``, after
its two train steps, so that it pays for one JAX compile fewer. The model,
a narrow SpUNet-v1m3 with the recipe's class vocabulary
(``ppt_vocab``, the committed ppt36 text embeddings) and CE + Lovász, runs
one seeded batch of two synthetic scenes for two conditions, the head and
the backbone ordering their conditions differently. Tolerances: logits 1e-4
of max|ref| (convs summed in another order than XLA's), the loss 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ponderv2_tpu.models import build_model as jbuild
from ponderv2_tpu_torch.models import build_model as tbuild
from jax_compile import background_compile
from test_torch_ppt import (
    PPT_V1M2,
    SHAPE,
    _torch_state,  # noqa: F401  (autouse fixture)
    arrays_of,
    assert_rel,
    jax_cfg,
    ppt_variables,
    randomize,
    scene_batch,
)
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)


@pytest.mark.parametrize("cfg", [PPT_V1M2], ids=["v1m2"])
def test_ppt_logits_and_loss_match_jax(cfg):
    """Logits (input row order) within 1e-4 of max|ref| and the loss within
    1e-5, for two conditions; the head's index of a condition picks the
    embedding row and the valid classes (or the seg head), the backbone its
    own index picks the norms."""
    model = randomize(tbuild(dict(cfg))).eval()
    jmodel = jbuild(jax_cfg(cfg))
    batch = arrays_of(scene_batch())
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ctx = {"spatial_shape": SHAPE, "batch_size": 2}
    variables = ppt_variables(model, cfg)
    compiled = {cond: background_compile(jax.jit(lambda v, b, cond=cond: jmodel.apply(
        v, {**b, **ctx, "condition": cond}, train=False)), variables, jbatch)
        for cond in ("ScanNet", "S3DIS")}  # lowered in turn, compiled side by side
    logits = {}
    for cond in ("ScanNet", "S3DIS"):
        ref = compiled[cond].result()(variables, jbatch)
        with torch.inference_mode():
            out = model({**{k: torch.from_numpy(v) for k, v in batch.items()},
                         "spatial_shape": SHAPE, "batch_size": 2,
                         "condition": [cond, cond]})
        assert bool(out["contract_ok"])
        assert_rel(out["seg_logits"].numpy(), ref["seg_logits"], 1e-4, f"{cond} logits")
        assert abs(float(out["loss"]) - float(ref["loss"])) <= 1e-5 * float(ref["loss"])
        logits[cond] = out["seg_logits"].numpy()
    a, b = logits["ScanNet"], logits["S3DIS"]
    assert a.shape != b.shape or not np.allclose(a, b)
