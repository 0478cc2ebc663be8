"""The data × seq × model grid of ranks (``pytorch_distributed_tpu/parallel/mesh.py``).

``make_mesh`` lays ``dp * sp * mp`` ranks out in the JAX grid order
``(data, seq, model)`` (``make_mesh``:52): rank ``(d * sp + s) * mp + m``
holds data replica ``d``, sequence shard ``s`` and model shard ``m`` (with
``mp`` 1, rank ``d * sp + s``). It builds one process group along each
axis through every point of the others and registers this rank's three
under the JAX axis names (``DATA_AXIS``, ``SEQ_AXIS``, ``MODEL_AXIS``), so
that a model config names its ring's group as the JAX config names its
mesh axis (``TransformerConfig.seq_axis``, ``model_axis``). The model axis
carries the pipeline's stages (``train.pp``) or the Megatron shards of
tensor parallelism (``parallel.tensor``). ``Mesh.data_seq`` is the group
of the (data, seq) points of this rank's model index: the JAX steps'
``psum`` over ``(data, seq)``, which leaves the model axis alone (the
whole job when the model axis has size 1). ``Mesh.model_cpu`` is the
model axis over gloo (the model group itself on a gloo job, else a gloo
group of the same ranks), for host values the model ranks exchange (the
tensor-parallel serve's rank-0 readings, ``serving.scheduler``). Every
rank must call ``make_mesh`` with the same sizes, as
``torch.distributed.new_group`` requires.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch.distributed as dist

from pytorch_distributed_tpu_torch.parallel.distributed import ranks_per_node

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"

_groups: Dict[str, "AxisGroup"] = {}


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One axis of the grid as this rank sees it: its process group (None
    for an axis of size 1), its size and this rank's index along it."""

    group: Optional[dist.ProcessGroup]
    size: int
    index: int


_ONE = AxisGroup(None, 1, 0)


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: AxisGroup
    seq: AxisGroup
    model: AxisGroup = _ONE
    #: the (data, seq) points of this rank's model index, index d·S + s
    data_seq: Optional[AxisGroup] = None
    #: the model axis over gloo (host values); None for an axis of size 1
    model_cpu: Optional[AxisGroup] = None

    def __post_init__(self):
        if self.data_seq is None:  # a hand-made mesh: no model axis
            object.__setattr__(self, "data_seq", AxisGroup(
                None, self.data.size * self.seq.size,
                self.data.index * self.seq.size + self.seq.index))

    def rank_of(self, data: int = 0, seq: int = 0, model: int = 0) -> int:
        """The global rank at grid point ``(data, seq, model)``."""
        return (data * self.seq.size + seq) * self.model.size + model

    def axis_size(self, name: str) -> Optional[int]:
        """The size of the axis registered under ``name`` (None for a name
        the grid has not): the JAX ``mesh.shape.get(name)``."""
        return {DATA_AXIS: self.data.size, SEQ_AXIS: self.seq.size,
                MODEL_AXIS: self.model.size}.get(name)


def make_mesh(data_parallel: int, seq_parallel: int = 1, model_parallel: int = 1) -> Mesh:
    """This rank's place in a ``data_parallel x seq_parallel x
    model_parallel`` grid over the whole process group (rank =
    (d·sp + s)·mp + m), with the axes' groups registered under
    ``DATA_AXIS``, ``SEQ_AXIS`` and ``MODEL_AXIS``. Without a process
    group only the 1 x 1 x 1 grid exists."""
    sizes = (data_parallel, seq_parallel, model_parallel)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if min(sizes) < 1 or data_parallel * seq_parallel * model_parallel != world:
        raise ValueError(f"mesh {'x'.join(map(str, sizes))} != {world} processes")
    rank = dist.get_rank() if dist.is_initialized() else 0
    mine = (rank // (seq_parallel * model_parallel), (rank // model_parallel) % seq_parallel,
            rank % model_parallel)
    axes = []
    for axis, n in enumerate(sizes):
        group = None
        # new_group is collective over the whole group: every rank builds
        # every line of every axis, in the same order
        others = [range(m) for k, m in enumerate(sizes) if k != axis]
        for a in others[0]:
            for b in others[1]:
                line = []
                for i in range(n):
                    point = [a, b]
                    point.insert(axis, i)
                    line.append((point[0] * seq_parallel + point[1]) * model_parallel + point[2])
                g = dist.new_group(line) if n > 1 else None
                if rank in line:
                    group = g
        axes.append(AxisGroup(group, n, mine[axis]))
    # the (data, seq) plane of each model index; with one model index the
    # whole job, as the default group
    n = data_parallel * seq_parallel
    plane = None
    if model_parallel == 1:
        plane = dist.group.WORLD if n > 1 else None
    else:
        for m in range(model_parallel):
            line = list(range(m, world, model_parallel))
            g = dist.new_group(line) if n > 1 else None
            if rank in line:
                plane = g
    model_cpu = None
    if model_parallel > 1:
        # the model lines again over gloo, unless the job's backend is gloo
        cpu = axes[2].group
        if dist.get_backend() != dist.Backend.GLOO:
            for a in range(data_parallel):
                for b in range(seq_parallel):
                    line = [(a * seq_parallel + b) * model_parallel + m
                            for m in range(model_parallel)]
                    g = dist.new_group(line, backend="gloo")
                    if rank in line:
                        cpu = g
        model_cpu = AxisGroup(cpu, model_parallel, mine[2])
    mesh = Mesh(*axes, data_seq=AxisGroup(plane, n, mine[0] * seq_parallel + mine[1]),
                model_cpu=model_cpu)
    _groups[DATA_AXIS], _groups[SEQ_AXIS], _groups[MODEL_AXIS] = axes
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
    ranks over the seq and model axes' sizes, so every seq shard and
    every stage of a replica gets its rows (JAX replicates the batch over
    the model axis). A node's loader batches this many per-replica
    batches; 1 without a mesh."""
    if mesh is None:
        return 1
    return max(ranks_per_node() // (mesh.seq.size * mesh.model.size), 1)


def local_replica_index(mesh: Optional[Mesh]) -> int:
    """This rank's replica among its node's (rows ``[i·bs, (i+1)·bs)`` of
    the node batch)."""
    return 0 if mesh is None else mesh.data.index % local_replica_count(mesh)
