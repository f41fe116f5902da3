"""PyTorch port vs JAX package: the nuScenes configs' conv plans.

The plan kind at each level, the rulebooks and the band plans, equal to
JAX's at nuScenes' ``sparse_shape`` (1440, 1440, 108) at the pretrain's
batch 4 and the fine-tune's batch 12, on coordinates that span the grid
(``test_torch_outdoor_model.py`` holds the PonderOutdoor-v2 step).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ponderv2_tpu.models.sparse_unet import plans as jplans
from ponderv2_tpu.ops.spconv import SubmPlan as JSubmPlan
from ponderv2_tpu_torch.models.sparse_unet import plans as tplans
from ponderv2_tpu_torch.ops.spconv import SubmPlan
from jax_compile import jit
from test_torch_outdoor_model import NUSCENES, NUSCENES_SHAPE, _torch_state  # noqa: F401
from torch_threads import _torch_threads  # noqa: F401  (autouse fixture)


def lidar_coords(batch_size, rng, n=600):
    """Unique voxel coords of ``batch_size`` scans spread over nuScenes'
    whole grid: rings 20-720 cells from the centre, every height."""
    rows = []
    for b in range(batch_size):
        r, a = rng.uniform(20, 720, n), rng.uniform(0, 2 * np.pi, n)
        x = np.clip(720 + r * np.cos(a), 0, NUSCENES_SHAPE[0] - 1).astype(int)
        y = np.clip(720 + r * np.sin(a), 0, NUSCENES_SHAPE[1] - 1).astype(int)
        z = rng.randint(0, NUSCENES_SHAPE[2], n)
        rows.append(np.unique(np.stack([np.full(n, b), x, y, z], 1), axis=0))
    return np.concatenate(rows).astype(np.int32)


@pytest.mark.parametrize("batch_size,rulebook_levels", [(4, [0]), (12, [0, 1])])
def test_plans_at_nuscenes_shape_match_jax(batch_size, rulebook_levels):
    """At (1440, 1440, 108): the pretrain's batch 4 takes plain rulebooks at
    L0 (8.96e8 cells), the fine-tune's batch 12 at L0 and L1 (2.69e9,
    3.36e8), both above the 192 Mi dense-grid limit; every other level a
    SubmPlan with a band plan. Per level the plan kind, the rulebook and
    the band plan (windows, tap rows, overflow entries, ok) equal JAX's,
    and the k5 stem's rulebook too."""
    coords = lidar_coords(batch_size, np.random.RandomState(batch_size))
    cap = 8192
    coords = np.concatenate([coords, np.full((cap - len(coords), 4), -1, np.int32)])
    ch = tuple(NUSCENES.model.backbone.channels)
    caps = tplans.capacity_schedule(cap, len(ch) // 2)
    build = jit(jplans.build_spunet_plans, static_argnums=(1, 2, 3, 4))
    jp = build(jnp.asarray(coords), NUSCENES_SHAPE, batch_size, caps, ch)
    tp = tplans.build_spunet_plans(torch.from_numpy(coords), NUSCENES_SHAPE, batch_size,
                                   caps, ch)
    assert np.array_equal(np.asarray(jp.stem), tp.stem.numpy())
    got_rulebook = []
    for level, (a, b) in enumerate(zip([jp.l0, *jp.subm], [tp.l0, *tp.subm])):
        assert isinstance(a, JSubmPlan) == isinstance(b, SubmPlan), level
        if not isinstance(b, SubmPlan):
            got_rulebook.append(level)
            assert np.array_equal(np.asarray(a), b.numpy()), level
            continue
        assert np.array_equal(np.asarray(a.legacy), b.legacy.numpy()), level
        assert bool(a.sorted_ok) and bool(b.sorted_ok)
        assert a.band is not None and b.band is not None, level
        for field in ("rbt", "w0", "ok", "ov_i", "ov_j", "ov_t"):
            assert np.array_equal(np.asarray(getattr(a.band, field)),
                                  getattr(b.band, field).numpy()), (level, field)
    assert got_rulebook == rulebook_levels
