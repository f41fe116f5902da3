"""PyTorch port vs JAX package: PonderIndoor-v2's loss and its terms under
each of the multi-dataset pretrain's three conditions.

``test_torch_multidataset_model.py``'s model, batch and seeded weights
(its docstring): per condition (Structured3D, ScanNet, S3DIS), the loss
and its terms of one training forward against JAX ``model.apply`` with
``condition`` in the input and the JAX train step's key at step 0, 1e-3
relative. The three JAX forwards (the condition is static, so one compile
each) are lowered in turn and compiled side by side in one module fixture.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from ponderv2_tpu_torch.models import build_model as tbuild
from jax_compile import background_compile
from test_torch_multidataset_model import (CONDITIONS, MODEL, TERMS, _torch_state,  # noqa: F401
                                           port_forward, seeded_setup)
from test_torch_pretrain_step import LOSS_REL, assert_rel
from torch_threads import _torch_threads  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def jax_run():
    """The seeded weights and the JAX training forward's loss terms at each
    condition."""
    run = seeded_setup()
    variables = jax.tree.map(jnp.asarray, {"params": run.params, "batch_stats": run.stats,
                                           "constants": run.constants})
    jarr = {k: jnp.asarray(v) for k, v in run.arrays.items()}
    compiled = {}
    for cond in CONDITIONS:
        fwd = jax.jit(lambda v, a, rng, cond=cond: run.jmodel.apply(
            v, {**a, **run.ctx, "condition": cond, "rng": rng}, train=True,
            mutable=["batch_stats", "diagnostics"])[0])
        compiled[cond] = background_compile(fwd, variables, jarr, run.key)
    run.terms = {}
    for cond, future in compiled.items():
        out = future.result()(variables, jarr, run.key)
        run.terms[cond] = {k: float(out[k]) for k in TERMS}
    return run


@pytest.mark.parametrize("condition", CONDITIONS)
def test_loss_terms_per_condition_match_jax(jax_run, condition):
    """Each condition's loss and terms (its ``valid_index`` rows of the 36
    class embeddings in the semantic and PPT losses) against JAX; the
    conditions' PPT losses differ, so the subset is taken."""
    model = tbuild(dict(MODEL))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in jax_run.init.items()})
    model.train()
    ci = CONDITIONS.index(condition)
    assert model.class_embedding.shape[0] == 36
    assert len(model.valid_index[ci]) == (25, 20, 13)[ci]
    with torch.no_grad():
        out = port_forward(model, jax_run, condition)
    for k in TERMS:
        assert_rel(float(out[k]), jax_run.terms[condition][k], LOSS_REL, f"{condition} {k}")
    ppt = [jax_run.terms[c]["ppt_loss"] for c in CONDITIONS]
    assert len(set(ppt)) == 3
