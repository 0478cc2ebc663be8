"""The serving fleet (``pytorch_distributed_tpu/fleet``): the replica
router (``router.FleetRouter``: session affinity, the SLO gate, one host
loop over the replicas, synchronous or lagged, the prefill-to-decode
handoff and the failure plane), the admission policy
(``admission.SLOGate``, ``recommend_replicas``) and seeded traffic traces
(``traffic``)."""

from pytorch_distributed_tpu_torch.fleet.admission import (
    ADMIT,
    PREEMPT,
    SHED,
    SPILL,
    Decision,
    SLOConfig,
    SLOGate,
    recommend_replicas,
)
from pytorch_distributed_tpu_torch.fleet.router import FleetRouter
from pytorch_distributed_tpu_torch.fleet.traffic import (
    TraceRequest,
    clamp_trace,
    generate_trace,
    iter_trace,
    load_trace,
    prompt_for,
    replay_stream,
    replay_trace,
    save_trace,
    shared_prefix_prompt_for,
)

__all__ = ["ADMIT", "PREEMPT", "SHED", "SPILL", "Decision", "FleetRouter", "SLOConfig",
           "SLOGate", "TraceRequest", "clamp_trace", "generate_trace", "iter_trace",
           "load_trace", "prompt_for", "recommend_replicas", "replay_stream", "replay_trace",
           "save_trace", "shared_prefix_prompt_for"]
