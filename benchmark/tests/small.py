"""Cells at a size the CPU holds, for the tests."""

from benchmark.harness import core

SMALL = {"point_budget": 8192, "model.backbone.capacities": (8192,) * 5}
MIX = {"scenes": 2, "points": 2000}


def ctx(workload: str, seed: int, seconds: float, tmp: str, controls=()) -> core.Ctx:
    """A CPU run of ``workload`` at a small size."""
    return core.Ctx(workload, seed, seconds, False, device="cpu", tmp=tmp,
                    mix_overrides=MIX, options=SMALL, controls=controls)
