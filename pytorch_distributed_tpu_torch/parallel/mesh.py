"""The data × seq grid of ranks (``pytorch_distributed_tpu/parallel/mesh.py``).

``make_mesh`` lays ``dp * sp`` ranks out in the JAX grid order
``(data, seq, model)`` (``make_mesh``:94), model of size 1: rank
``d * sp + s`` holds data replica ``d`` and sequence shard ``s``. It
builds one process group per row and column and registers this rank's
two under the JAX axis names (``DATA_AXIS``, ``SEQ_AXIS``), so that a
model config names its ring's group as the JAX config names its mesh axis
(``TransformerConfig.seq_axis``). Every rank must call ``make_mesh`` with
the same sizes, as ``torch.distributed.new_group`` requires.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch.distributed as dist

from pytorch_distributed_tpu_torch.parallel.distributed import ranks_per_node

DATA_AXIS = "data"
SEQ_AXIS = "seq"

_groups: Dict[str, "AxisGroup"] = {}


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One axis of the grid as this rank sees it: its process group (None
    for an axis of size 1), its size and this rank's index along it."""

    group: Optional[dist.ProcessGroup]
    size: int
    index: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: AxisGroup
    seq: AxisGroup


def make_mesh(data_parallel: int, seq_parallel: int = 1) -> Mesh:
    """This rank's place in a ``data_parallel x seq_parallel`` grid over
    the whole process group (rank = d·sp + s), with the axes' groups
    registered under ``DATA_AXIS`` and ``SEQ_AXIS``. Without a process
    group only the 1 x 1 grid exists."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data_parallel < 1 or seq_parallel < 1 or data_parallel * seq_parallel != world:
        raise ValueError(f"mesh {data_parallel}x{seq_parallel} != {world} processes")
    rank = dist.get_rank() if dist.is_initialized() else 0
    d, s = divmod(rank, seq_parallel)
    seq = data = None
    # new_group is collective over the whole group: every rank builds every group
    for row in range(data_parallel):
        ranks = [row * seq_parallel + c for c in range(seq_parallel)]
        g = dist.new_group(ranks) if seq_parallel > 1 else None
        if row == d:
            seq = g
    for col in range(seq_parallel):
        ranks = [r * seq_parallel + col for r in range(data_parallel)]
        g = dist.new_group(ranks) if data_parallel > 1 else None
        if col == s:
            data = g
    mesh = Mesh(AxisGroup(data, data_parallel, d), AxisGroup(seq, seq_parallel, s))
    _groups[DATA_AXIS], _groups[SEQ_AXIS] = mesh.data, mesh.seq
    return mesh


def axis_group(name: str) -> AxisGroup:
    """The axis registered under ``name`` by the last ``make_mesh``; raises
    when there is none."""
    try:
        return _groups[name]
    except KeyError:
        raise RuntimeError(
            f"no mesh axis {name!r}: build the grid with parallel.mesh.make_mesh "
            "first (ring attention runs inside a sequence-parallel group)") from None


def as_axis(group) -> AxisGroup:
    """An ``AxisGroup`` from itself, a process group (this rank's index and
    the group's size) or None (the axis registered under ``SEQ_AXIS``)."""
    if group is None:
        return axis_group(SEQ_AXIS)
    if isinstance(group, AxisGroup):
        return group
    return AxisGroup(group, dist.get_world_size(group), dist.get_rank(group))


def global_batch_size(mesh: Mesh, per_replica_batch: int) -> int:
    """Per-replica batch × the data axis's size."""
    return per_replica_batch * mesh.data.size


def local_replica_count(mesh: Optional[Mesh]) -> int:
    """Data replicas this node feeds (``local_replica_count``:165): its
    ranks over the seq axis's size. A node's loader batches this many
    per-replica batches; 1 without a mesh."""
    if mesh is None:
        return 1
    return max(ranks_per_node() // mesh.seq.size, 1)


def local_replica_index(mesh: Optional[Mesh]) -> int:
    """This rank's replica among its node's (rows ``[i·bs, (i+1)·bs)`` of
    the node batch)."""
    return 0 if mesh is None else mesh.data.index % local_replica_count(mesh)
