"""PyTorch port vs JAX package: the small DefaultSegmentor forward at
ScanNet's sparse_shape (1024, 1024, 512), where L0 is too large for the JAX
package's dense grid: the stem and L0 convs use plain rulebooks, and the L0
decoder convs (cin 88 and 72, above 64) build band plans inline. The case,
model and tolerance are those of ``test_torch_segmentor_dense.py``."""

import numpy as np

from test_torch_segmentor_dense import _torch_state, run_case  # noqa: F401
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)


def test_segmentor_forward_legacy_l0():
    ref, j_ok, out, t_ok, routes = run_case((1024, 1024, 512))
    assert j_ok and t_ok
    assert np.abs(ref).max() > 0.3
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    # module order: stem, enc, then dec by module index (0 runs at L0)
    assert routes.count("plain") == 1 and routes[0] == "plain"
    assert routes.count("band-inline") == 2
    assert routes.count("band-attached") == 14
