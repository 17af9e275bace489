"""Process-group set-up for multi-process training.

Counterpart of ``deepipr_tpu/parallel/distributed.py``. The JAX package
calls ``jax.distributed.initialize`` before the first device use, and its
SPMD mesh then spans every process's devices. Here every process is one
rank of a ``torch.distributed`` process group, set up by
``maybe_initialize_distributed`` from its arguments or from the variables
that ``torchrun`` exports (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``):

    torchrun --nproc-per-node 4 -m deepipr_tpu_torch.cli.train_v23 \\
        --multihost --epoch-scan ...

The backend is ``nccl`` for ranks on CUDA and ``gloo`` on the CPU. NCCL
refuses two ranks on one GPU; several ranks on one card take ``gloo``,
whose CUDA tensors support ``all_reduce``, ``broadcast`` and ``barrier``,
the only collectives the port's parallel path calls (parallel/mesh.py).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from deepipr_tpu_torch.utils.device import DeviceLike


def default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def rank_device(device: Optional[DeviceLike] = None) -> torch.device:
    """The device of this rank: ``device`` where the caller names one
    (``"cuda"`` without an index counts as unnamed), else ``cuda:LOCAL_RANK``
    with a GPU and the CPU without."""
    if device is not None:
        dev = torch.device(device)
        if dev.type != "cuda" or dev.index is not None:
            return dev
    if device is None and not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def maybe_initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    auto: bool = False,
    backend: Optional[str] = None,
) -> bool:
    """Set up the default process group when one is configured; returns
    True iff a process group is up afterwards.

    ``coordinator_address`` is ``host:port`` (a TCP rendezvous) or a full
    URL (``file:///path`` for a shared-file rendezvous); it defaults to
    ``MASTER_ADDR:MASTER_PORT``, ``num_processes`` to ``WORLD_SIZE`` and
    ``process_id`` to ``RANK``. With nothing configured it does nothing and
    returns False, unless ``auto`` (the CLIs' ``--multihost``), which sets
    up a world of one process on an in-process store. A group that is
    already up is kept. With NCCL the current CUDA device becomes
    ``cuda:LOCAL_RANK``. Call it before the first device use.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    backend = backend or default_backend()
    if coordinator_address is None and num_processes is None and not auto:
        return False
    if backend == "nccl":
        torch.cuda.set_device(rank_device())
    if coordinator_address is None and num_processes is None:
        dist.init_process_group(backend=backend, store=dist.HashStore(),
                                world_size=1, rank=0)
        return True
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "multi-process set-up needs a coordinator address, a process "
            f"count and a process id; got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}")
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return True


def world() -> int:
    """Processes in the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0
