"""GPipe over the model axis (``pytorch_distributed_tpu/parallel/pipeline.py``:
``gpipe``:31).

Each rank of the model group is one stage and holds its own slice of the
layer stack. ``gpipe`` runs M microbatches through the S stages: all the
forwards, then, on ``Pipe.backward``, all the backwards in reverse order
(GPipe's schedule, bubble (S-1)/(M+S-1)). A stage's output for microbatch
m goes to its successor, and the gradient of its input back to its
predecessor, by point-to-point sends; every stage posts its sends and
receives in one order (forward 0..M-1, backward M-1..0), so the pairs
always match.

The JAX executor is one ``lax.scan`` over M + S - 1 ticks, computing and
masking a garbage microbatch at each stage's warm-up and drain ticks.
Here a stage computes only its M real microbatches, so nothing needs a
mask: the MoE aux losses summed over a stage's microbatches are the JAX
executor's masked sum over its real ticks. The stage function's contract
is the JAX one, ``stage_fn(stage_params, x, mb_idx)``, the index of the
microbatch at hand (for its dropout masks); the JAX executor's sniffing
of 2-argument stage functions is a compatibility shim of the JAX package
and is not ported.

Backends: on NCCL each send and receive is a ``batch_isend_irecv`` of one
op; on gloo, CUDA tensors are staged through the host, as
``parallel.collectives`` does.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.parallel.collectives import staged
from pytorch_distributed_tpu_torch.parallel.mesh import AxisGroup


class _Channel:
    """Sends and receives between this stage and its neighbours on
    ``axis``; a send stays in flight (with the tensor it reads) until
    ``flush``."""

    def __init__(self, axis: AxisGroup):
        self.axis = axis
        self._pending: list = []

    def _peer(self, stage: int) -> int:
        return dist.get_global_rank(self.axis.group, stage)

    def send(self, t: torch.Tensor, stage: int) -> None:
        t = t.detach()
        buf = t.cpu() if staged(self.axis.group, t) else t.contiguous()
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, self._peer(stage),
                                                   self.axis.group)])
        self._pending.append((works, buf))

    def recv(self, like: torch.Tensor, stage: int) -> torch.Tensor:
        host = staged(self.axis.group, like)
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if host else like.device)
        for w in dist.batch_isend_irecv([dist.P2POp(dist.irecv, buf, self._peer(stage),
                                                    self.axis.group)]):
            w.wait()
        return buf.to(like.device) if host else buf

    def flush(self) -> None:
        for works, _ in self._pending:
            for w in works:
                w.wait()
        self._pending = []


class Pipe:
    """One ``gpipe`` call's microbatches on this stage: ``outputs`` (this
    stage's, real on the last), ``losses`` (the last stage's ``head`` of
    each), ``aux`` (this stage's aux losses summed over its microbatches,
    with ``has_aux``); ``backward`` runs the backwards."""

    def __init__(self, axis, channel, inputs, outputs, losses, aux):
        self.axis, self._channel = axis, channel
        self._inputs, self.outputs, self.losses = inputs, outputs, losses
        self._aux = aux
        self.aux = torch.stack(aux).sum() if aux else None

    def backward(self, aux_weight: float = 0.0) -> None:
        """All M backwards, last microbatch first: the last stage from its
        ``losses``, every other from the gradient its successor sends;
        each stage but the first sends its input's gradient back. Each
        microbatch's aux loss enters with weight ``aux_weight``. The
        stage's parameters accumulate their gradients."""
        s, n = self.axis.index, self.axis.size
        last = s == n - 1
        for m in reversed(range(len(self.outputs))):
            tensors, grads = [], []
            if last:
                tensors.append(self.losses[m])
                grads.append(torch.ones_like(self.losses[m]))
            else:
                tensors.append(self.outputs[m])
                grads.append(self._channel.recv(self.outputs[m], s + 1))
            if self._aux and self._aux[m].requires_grad and aux_weight:
                tensors.append(self._aux[m])
                grads.append(torch.full_like(self._aux[m], aux_weight))
            torch.autograd.backward(tensors, grads)
            if s > 0:
                self._channel.send(self._inputs[m].grad, s - 1)
        self._channel.flush()


def gpipe(stage_fn: Callable, stage_params, microbatches: Sequence[torch.Tensor], *,
          axis: AxisGroup, head: Optional[Callable] = None, has_aux: bool = False) -> Pipe:
    """Run M microbatches through the pipeline over ``axis`` (every stage
    calls it, in the same order as its other collectives).

    ``stage_fn(stage_params, x, mb_idx) -> y`` (``-> (y, aux)`` with
    ``has_aux``) is this stage's computation; every stage maps the
    activation's shape and dtype to itself. ``microbatches``: M tensors;
    stage 0 consumes them (their graph is kept, so its backward reaches
    whatever made them), the other stages take only their shapes and
    dtypes. ``head(y, mb_idx) -> scalar``, on the last stage, is each
    microbatch's loss, computed as soon as its output is (the backward
    starts from these). Grad mode decides whether the backward can run.
    """
    s, n = axis.index, axis.size
    channel = _Channel(axis)
    grad = torch.is_grad_enabled()
    inputs: List[torch.Tensor] = []
    outputs: List[torch.Tensor] = []
    losses: List[torch.Tensor] = []
    aux: List[torch.Tensor] = []
    for m, mb in enumerate(microbatches):
        if s == 0:
            x = mb
        else:
            x = channel.recv(mb, s - 1).requires_grad_(grad)
        inputs.append(x)
        y = stage_fn(stage_params, x, m)
        if has_aux:
            y, a = y
            aux.append(a)
        outputs.append(y)
        if s < n - 1:
            channel.send(y, s + 1)
        elif head is not None:
            losses.append(head(y, m))
    channel.flush()
    return Pipe(axis, channel, inputs, outputs, losses, aux)

