"""Host-side SpUNet plan prefetch for the Trainer's input pipeline.

Counterpart of ``ponderv2_tpu/engines/plan_prefetch.py``. The SpUNet conv
plans (k5 stem, per-level k3 and band, strided, inverse) are integer
functions of the collated voxel coords alone. ``PlanPrefetchLoader`` wraps a
train loader and builds the next batch's plans on a background thread, on
the CPU (``models/sparse_unet/plans.py:host_build_spunet_plans``), while the
card runs the current step, and attaches them as ``batch["spunet_plans"]``;
the trainer copies them to the card from pinned memory
(``engines/common.py:plans_to_device``) and PonderIndoor-v2 hands them to its
backbone instead of building them inside the step.

A thread, as in the JAX package: PyTorch's CPU ops release the GIL, as
XLA:CPU's executables do, so the build overlaps the main thread's launches.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Optional

import numpy as np


def plan_cfg_from_model_cfg(model_cfg: Dict[str, Any],
                            static_ctx: Dict[str, Any]) -> Optional[dict]:
    """The host plan-build config, or None where the prefetch does not
    apply: the same conditions as the JAX function's (the model sets
    ``assume_sorted``, so host and device see the same row order, and its
    backbone is ``SpUNet-v1m1`` or ``-v1m2``). Like the JAX function it does
    not look at the model's type."""
    if not isinstance(model_cfg, dict):
        return None
    if not model_cfg.get("assume_sorted", False):
        return None
    bk = model_cfg.get("backbone")
    if not isinstance(bk, dict) or bk.get("type") not in (
        "SpUNet-v1m1", "SpUNet-v1m2",
    ):
        return None
    channels = tuple(bk.get("channels", (32, 64, 128, 256, 256, 128, 96, 96)))
    return dict(
        spatial_shape=tuple(static_ctx["spatial_shape"]),
        batch_size=int(static_ctx["batch_size"]),
        capacities=(tuple(bk["capacities"])
                    if bk.get("capacities") is not None else None),
        channels=channels,
        slab_conv=bool(bk.get("slab_conv", True)),
    )


def attach_plans(batch: Dict[str, Any], plan_cfg: dict) -> Dict[str, Any]:
    """Build plans for one collated batch and attach them as ``spunet_plans``."""
    from ..models.sparse_unet.plans import capacity_schedule, host_build_spunet_plans

    grid = np.asarray(batch["grid_coord"])
    caps = plan_cfg["capacities"]
    if caps is None:
        caps = capacity_schedule(grid.shape[0], len(plan_cfg["channels"]) // 2)
    plans = host_build_spunet_plans(
        grid, np.asarray(batch["batch"]), plan_cfg["spatial_shape"],
        plan_cfg["batch_size"], caps, plan_cfg["channels"],
        slab_conv=plan_cfg["slab_conv"],
    )
    out = dict(batch)
    out["spunet_plans"] = plans
    return out


class PlanPrefetchLoader:
    """Iterate a loader, attaching host-built plans ``depth`` batches ahead.
    An exception in the loader or in the build is raised in the consumer.
    ``build_seconds`` holds each batch's build time in the thread;
    ``dataset`` is the loader's (the ``DataCacheOperator`` hook reads it)."""

    def __init__(self, loader, plan_cfg: dict, depth: int = 2):
        self.loader = loader
        self.dataset = getattr(loader, "dataset", None)
        self.plan_cfg = plan_cfg
        self.depth = depth
        self.build_seconds = []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        sentinel = object()

        def worker():
            try:
                for batch in self.loader:
                    t0 = time.perf_counter()
                    batch = attach_plans(batch, self.plan_cfg)
                    self.build_seconds.append(time.perf_counter() - t0)
                    q.put(batch)
            except BaseException as e:  # raised again in the consumer
                q.put(e)
                return
            q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True,
                             name="spunet-plan-prefetch")
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
