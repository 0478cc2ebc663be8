"""Process-group bootstrap and local spawn
(``pytorch_distributed_tpu/parallel/distributed.py``).

The reference's environment contract (``restnet_ddp.py:87-94``), kept as
it is, including its quirk that ``WORLD_SIZE`` counts nodes and ``RANK`` is
the node index:

    MASTER_IP / MASTER_PORT   rendezvous address
    WORLD_SIZE                number of nodes
    RANK                      this node's index

Each node runs one process per local rank (one per card on CUDA), and the
global rank is ``node * procs_per_node + local_rank``, as the reference
computes it. The backend is the caller's choice: ``"nccl"`` for CUDA
tensors with a card per rank, ``"gloo"`` for CPU tensors (or, where the
caller asks for it, CUDA tensors staged through the host by
``parallel.collectives``). Nothing here picks a backend by itself.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEFAULT_TIMEOUT_S = 600.0
# ranks a node holds in the process group this process joined (None: none)
_ranks_per_node = None


def env_rendezvous(local_rank: int = 0, procs_per_node: int = 1):
    """``(init_method, world_size, rank)`` from the environment contract
    (module docstring), or None when ``MASTER_IP``/``MASTER_PORT`` are not
    both set."""
    ip, port = os.environ.get("MASTER_IP"), os.environ.get("MASTER_PORT")
    if not (ip and port):
        return None
    nodes = int(os.environ.get("WORLD_SIZE", "1"))
    node = int(os.environ.get("RANK", "0"))
    return (f"tcp://{ip}:{port}", nodes * procs_per_node,
            node * procs_per_node + local_rank)


def init_process_group(backend: str, *, init_method: Optional[str] = None,
                       world_size: Optional[int] = None, rank: Optional[int] = None,
                       local_rank: int = 0, procs_per_node: Optional[int] = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the job's process group. ``init_method``/``world_size``/``rank``
    given are used as they are: a ``file://`` rendezvous holds every rank
    on this node unless ``procs_per_node`` says otherwise, any other (a
    ``tcp://`` address may join nodes) needs ``procs_per_node``. Otherwise
    they come from the environment contract with this process's
    ``local_rank`` of ``procs_per_node`` (default 1). Raises when neither
    says where to meet. The trainers lay a node's batch over its ranks by
    ``ranks_per_node``, which this records."""
    global _ranks_per_node
    if init_method is not None and procs_per_node is None:
        if not init_method.startswith("file://"):
            raise ValueError(f"init_method {init_method!r} does not say how many ranks a node "
                             "holds: pass procs_per_node")
        procs_per_node = world_size
    if init_method is None:
        procs_per_node = procs_per_node or 1
        found = env_rendezvous(local_rank, procs_per_node)
        if found is None:
            raise RuntimeError(
                "no rendezvous: pass init_method, world_size and rank, or set "
                "MASTER_IP, MASTER_PORT, WORLD_SIZE (nodes) and RANK (node index)")
        init_method, world_size, rank = found
    if world_size is None or rank is None:
        raise ValueError("init_method given without world_size and rank")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    _ranks_per_node = procs_per_node


def spawn(fn: Callable, nprocs: int, args: Sequence = ()) -> None:
    """Run ``fn(local_rank, *args)`` in ``nprocs`` fresh processes (the
    ``spawn`` start method) and wait for all of them. ``fn`` must be
    importable by name from a module that imports no more than the child
    needs. If a process fails, the others are terminated and its error is
    raised here."""
    mp.start_processes(fn, args=tuple(args), nprocs=nprocs, join=True,
                       start_method="spawn")


def get_rank() -> int:
    """This process's global rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    """Number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Rank 0: the process that prints and writes (``restnet_ddp.py:36,66,145``)."""
    return get_rank() == 0


def barrier() -> None:
    """Block until every process reaches this point (no-op alone)."""
    if dist.is_initialized():
        dist.barrier()


def ranks_per_node() -> int:
    """Processes on each node of the job: 1 without a process group; as
    ``init_process_group`` recorded it; for a group joined another way,
    ``LOCAL_WORLD_SIZE`` (which ``torchrun`` sets). Raises when none of
    these says."""
    if not dist.is_initialized():
        return 1
    if _ranks_per_node:
        return _ranks_per_node
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if not local:
        raise RuntimeError(
            "ranks per node unknown: join through parallel.distributed.init_process_group, "
            "or set LOCAL_WORLD_SIZE")
    if dist.get_world_size() % int(local):
        raise RuntimeError(f"LOCAL_WORLD_SIZE {local} does not divide the world "
                           f"{dist.get_world_size()}")
    return int(local)


def node_index() -> int:
    """This process's node (``RANK`` of the environment contract)."""
    return get_rank() // ranks_per_node()


def node_count() -> int:
    """Nodes in the job (``WORLD_SIZE`` of the environment contract)."""
    return get_world_size() // ranks_per_node()


def destroy_process_group() -> None:
    global _ranks_per_node
    if dist.is_initialized():
        dist.destroy_process_group()
    _ranks_per_node = None


def rank_device(device: str, local_rank: int) -> torch.device:
    """The device of a local rank: the CPU, or card ``local_rank`` modulo
    the cards present (several ranks share a card only where there are
    fewer cards than ranks, which the NCCL backend refuses)."""
    if device == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", local_rank % n)
