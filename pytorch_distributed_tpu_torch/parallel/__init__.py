"""Multi-process training over ``torch.distributed``: rendezvous and spawn
(``parallel.distributed``), the data × seq grid of ranks and its process
groups (``parallel.mesh``), gradient all-reduce and the ring permute
(``parallel.collectives``), and ring attention with the zigzag layout
(``parallel.sequence``)."""
