"""k3_roofline: the k-means kernel's share of its roofline (%): the
yardstick's least time a tick for the inputs the traced run saw
(mclbench/bounds.k3_bound) over the kernel's device time a tick."""


def read(r):
    ms = r.ms_per_tick(lambda name: "kmeans_kernel" in name)
    bound = r.bounds.get("k3_ms_per_tick")
    if ms is None or bound is None:
        return None
    return 100.0 * bound / ms
