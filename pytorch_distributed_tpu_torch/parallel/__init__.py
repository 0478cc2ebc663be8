"""Multi-process training over ``torch.distributed``: rendezvous and spawn
(``parallel.distributed``), the data × seq × model grid of ranks and its
process groups (``parallel.mesh``), gradient all-reduce and the ring
permute (``parallel.collectives``), ring attention with the zigzag layout
(``parallel.sequence``), ZeRO-3 FSDP over the data axis
(``parallel.fsdp``) and the GPipe executor over the model axis
(``parallel.pipeline``)."""
