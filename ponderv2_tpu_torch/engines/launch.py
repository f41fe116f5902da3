"""Launch: run the main function (counterpart of
``ponderv2_tpu/engines/launch.py``).

The port runs one process on one card. An environment that asks for more
processes (a coordinator address for the JAX launcher, more than one SLURM
task or node, or ``WORLD_SIZE`` > 1) raises: data parallelism (ROADMAP
Queue 1, P14) is not ported, and a run must not go on quietly in one
process. A one-task SLURM job runs, as it does in JAX.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

_COORDINATOR_VARS = ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
                     "MEGASCALE_COORDINATOR_ADDRESS")
_COUNT_VARS = ("SLURM_NTASKS", "SLURM_JOB_NUM_NODES", "WORLD_SIZE")


def _asks_for_processes() -> bool:
    """Whether the environment asks for more than one process."""
    if os.environ.get("PONDER_DISABLE_DISTRIBUTED"):
        return False
    return (any(k in os.environ for k in _COORDINATOR_VARS)
            or any(int(os.environ.get(k, "1")) > 1 for k in _COUNT_VARS))


def launch(
    main_func: Callable,
    num_gpus_per_machine: int = 0,
    num_machines: int = 1,
    machine_rank: int = 0,
    dist_url: Optional[str] = None,
    cfg: Tuple = (),
    timeout=None,
) -> None:
    """``main_func(*cfg)`` in this process; raises where more than one
    process is asked for (the environment, ``num_machines`` or
    ``num_gpus_per_machine`` > 1)."""
    del machine_rank, dist_url, timeout
    if _asks_for_processes() or num_machines > 1 or num_gpus_per_machine > 1:
        raise NotImplementedError(
            "launch: more than one process was asked for, and the port runs one: "
            "data parallelism (P14, ROADMAP Queue 1) is not ported")
    main_func(*cfg)


# the reference's SLURM entry point: the environment check above covers it
slurm_launch = launch
