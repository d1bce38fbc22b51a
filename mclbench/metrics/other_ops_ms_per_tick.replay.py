"""other_ops_ms_per_tick.replay: device time a tick (ms) in operations
other than the three hand-written kernels (beam weights, systematic
expansion, k-means): the stage modules' torch operations and the graphs'
copies."""

KERNELS = ("beam_weights", "expand_block_kernel", "expand_scan_kernel",
           "expand_copy_kernel", "kmeans_kernel")


def read(r):
    return r.ms_per_tick(lambda name: not any(k in name for k in KERNELS))
