"""PyTorch port vs JAX package on the CPU: the MinkUNet family's basic
blocks, MinkUNet14A (``test_torch_backbones_mink50.py``: the bottleneck
blocks).

The cases, inputs, tolerances and checks are ``test_torch_backbones.py``'s
(its docstring); each JAX model is one jitted function in a module fixture
of its own, and the models sit in four files, so that the tier-1 command's
workers (``--dist loadfile``) compile them side by side.
"""

import pytest

from test_torch_backbones import _torch_state, check_backbone_matches_jax, jax_run  # noqa: F401
from torch_threads import _torch_threads  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module", params=["MinkUNet14A"])
def case(request):
    """The JAX run of one case, computed once for the module."""
    return jax_run(request.param)


def test_backbone_matches_jax(case):
    check_backbone_matches_jax(case)
