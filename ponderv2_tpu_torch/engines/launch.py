"""Launch: run the main function in one process, or in one process per GPU
(counterpart of ``ponderv2_tpu/engines/launch.py``; the reference's
``ponder/engines/launch.py`` spawns one process per GPU over NCCL, which
JAX's one process over a mesh of all local devices stands in for).

Where the processes come from, in this order:

- ``PONDER_DISABLE_DISTRIBUTED`` set: one process, no group, whatever the
  environment or the arguments say;
- a torchrun environment (``WORLD_SIZE`` > 1 with ``RANK``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` and ``MASTER_PORT``) or a SLURM job of more than one task
  (``SLURM_NTASKS``, ``SLURM_PROCID``, ``SLURM_LOCALID``; the address from
  ``dist_url``, else ``MASTER_ADDR`` / ``MASTER_PORT``): this process is
  one rank of it;
- ``num_machines * num_gpus_per_machine`` > 1: this process spawns
  ``num_gpus_per_machine`` ranks, ``machine_rank * num_gpus_per_machine +
  i``, which meet at ``dist_url`` (``"auto"``: a free port of this host,
  for one machine);
- else ``main_func(*cfg)`` in this process, with no group.

Each rank binds ``cuda:LOCAL_RANK``, or the device its config (the first
of ``cfg``) names: ``device=cpu``, or a card by index, which several ranks
may share. The backend is NCCL on a card and gloo on the CPU unless
``backend`` says otherwise: ranks sharing one card need gloo, since NCCL
refuses two ranks on one device, and nothing switches to it quietly. The
group is destroyed when ``main_func`` returns or raises.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Callable, Optional, Tuple

import torch

DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def _env_world() -> Optional[dict]:
    """The rank, world size and local rank the environment gives this
    process, where it asks for more than one process; else None."""
    if os.environ.get("PONDER_DISABLE_DISTRIBUTED"):
        return None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return dict(rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
                    local_rank=int(os.environ.get("LOCAL_RANK", "0")))
    if int(os.environ.get("SLURM_NTASKS", "1")) > 1:
        return dict(rank=int(os.environ["SLURM_PROCID"]),
                    world_size=int(os.environ["SLURM_NTASKS"]),
                    local_rank=int(os.environ.get("SLURM_LOCALID", "0")))
    return None


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _bind_device(cfg: Tuple, local_rank: int) -> torch.device:
    """The device of this rank (set as the config's ``device`` when the
    config leaves it to the rank, and made current on a card)."""
    config = cfg[0] if cfg and hasattr(cfg[0], "get") else None
    name = config.get("device") if config is not None else None
    dev = torch.device(name) if name else torch.device("cuda", local_rank)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device=cpu (e.g. --options "
                               "device=cpu) to run the ranks on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if config is not None:
        config["device"] = str(dev)
    return dev


def _run_rank(main_func: Callable, cfg: Tuple, local_rank: int, backend: Optional[str],
              timeout, **group) -> None:
    """Join the process group as one rank, run ``main_func(*cfg)``, leave."""
    import torch.distributed as dist

    dev = _bind_device(cfg, local_rank)
    backend = backend or ("gloo" if dev.type == "cpu" else "nccl")
    dist.init_process_group(backend, timeout=timeout or DEFAULT_TIMEOUT, **group)
    try:
        main_func(*cfg)
    finally:
        dist.destroy_process_group()


def _distributed_worker(local_rank: int, main_func: Callable, world_size: int,
                        num_gpus_per_machine: int, machine_rank: int, dist_url: str,
                        backend: Optional[str], cfg: Tuple, timeout) -> None:
    """The body of a spawned rank (a module-level function: spawn pickles it)."""
    os.environ["LOCAL_RANK"] = str(local_rank)
    _run_rank(main_func, cfg, local_rank, backend, timeout, init_method=dist_url,
              world_size=world_size, rank=machine_rank * num_gpus_per_machine + local_rank)


def launch(
    main_func: Callable,
    num_gpus_per_machine: int = 0,
    num_machines: int = 1,
    machine_rank: int = 0,
    dist_url: Optional[str] = None,
    cfg: Tuple = (),
    timeout=None,
    backend: Optional[str] = None,
) -> None:
    """``main_func(*cfg)`` on every rank the environment or the arguments
    ask for (module docstring). Where ranks are spawned, ``main_func`` and
    ``cfg`` must pickle, and a CPU tensor in ``cfg`` reaches every rank as
    one tensor in shared memory (``torch.multiprocessing``), not a copy."""
    if os.environ.get("PONDER_DISABLE_DISTRIBUTED"):
        main_func(*cfg)
        return
    env = _env_world()
    if env is not None:
        _run_rank(main_func, cfg, env["local_rank"], backend, timeout,
                  init_method=dist_url or "env://", world_size=env["world_size"],
                  rank=env["rank"])
        return
    world_size = num_machines * max(num_gpus_per_machine, 1)
    if world_size == 1:
        main_func(*cfg)
        return
    if dist_url in (None, "auto"):
        if num_machines > 1:
            raise ValueError("launch: dist_url='auto' is for one machine; give every "
                             "machine the first one's tcp://host:port")
        dist_url = f"tcp://127.0.0.1:{_free_port()}"
    import torch.multiprocessing as mp

    mp.start_processes(
        _distributed_worker, nprocs=num_gpus_per_machine, join=True, start_method="spawn",
        args=(main_func, world_size, num_gpus_per_machine, machine_rank, dist_url, backend,
              cfg, timeout))


# the reference's SLURM entry point: ``launch`` reads the SLURM environment
slurm_launch = launch
