"""PyTorch port vs JAX package: two SGD-Nesterov steps of the small
DefaultSegmentor at (160, 160, 64), where every level fits the JAX
package's dense grid: the stem on its slab plan and every other conv on a
slab plan with an attached band plan. The case, model and tolerances are
those of ``test_torch_train.py``; ``test_torch_train_scannet.py`` runs
ScanNet's sparse_shape."""

from test_torch_train import _torch_state, run_two_steps  # noqa: F401
from torch_threads import _torch_threads  # noqa: F401  (autouse fixture)


def test_two_sgd_steps_match_jax_train_step_dense_levels():
    """Every level has a slab plan with an attached band plan (the scenes
    fit the JAX dense grid); ``test_torch_train_scannet.py`` runs ScanNet's
    sparse_shape."""
    routes = run_two_steps((160, 160, 64))
    assert routes[0] == "slab" and routes[1:] == ["band-attached"] * 16
