"""PyTorch port vs JAX package: two SGD-Nesterov steps of the small
DefaultSegmentor at ScanNet's sparse_shape (1024, 1024, 512), where L0 is
too large for the JAX package's dense grid: the stem and L0 convs use plain
rulebooks, and the L0 decoder convs (cin 88 and 72, above 64) build band
plans inline. The case, model and tolerances are those of
``test_torch_train.py``."""

from test_torch_train import _torch_state, run_two_steps  # noqa: F401
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)


def test_two_sgd_steps_match_jax_train_step_scannet_shape():
    routes = run_two_steps((1024, 1024, 512))
    # module order: stem, enc, then dec by module index (0 runs at L0)
    assert routes.count("plain") == 1 and routes[0] == "plain"
    assert routes.count("band-inline") == 2
    assert routes.count("band-attached") == 14
