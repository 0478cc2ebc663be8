"""Run-level utilities: rank-aware printing (``utils.logging``), the
preemption watcher (``utils.suspend``) and the sharded checkpoint format
(``utils.checkpoint``)."""
