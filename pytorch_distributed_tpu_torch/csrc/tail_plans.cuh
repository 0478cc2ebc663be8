// The tile plans of the bf16 reductions (tail_reduce_wgmma_kernel in
// bottleneck_tail.cu), one TAIL_PLAN row each. The one table of them: the
// kernel source includes it to instantiate one kernel a row, and
// ops/bottleneck_tail.py reads it to choose a row by F (the first row of the
// function whose F bound covers F) and passes the row's index.
//
// TAIL_PLAN(gated, F up to (0: any F), kM, kN, rows a stage, stages)
//   gated 1: tail_bwd_reduce, 0: moments. The tile is kM x kN units of
//   64 x 64 (kM boxes of z's channels, kN of B's); a stage is kM + kN (+ kN
//   for out when gated) boxes of 64 channels x rows, and the ring holds
//   `stages` of them (about 200 KB of shared memory).
//   tail_bwd_reduce's tiles span F, except at 128 < F <= 256, where the F
//   tiles of one row range run side by side and the second reads g and out
//   from L2. moments' square super-tiles take the upper triangle.
//   No include guard: each includer defines TAIL_PLAN to what it needs.
TAIL_PLAN(1, 64, 1, 4, 64, 3)
TAIL_PLAN(1, 256, 2, 2, 64, 4)
TAIL_PLAN(1, 0, 8, 1, 32, 5)
TAIL_PLAN(0, 64, 1, 1, 64, 12)
TAIL_PLAN(0, 0, 2, 2, 64, 6)
