"""k1_roofline: the beam-weight kernel's share of its roofline (%): the
yardstick's least time a tick for the inputs the traced run saw
(mclbench/bounds.k1_bound) over the kernel's device time a tick."""


def read(r):
    ms = r.ms_per_tick(lambda name: "beam_weights" in name)
    bound = r.bounds.get("k1_ms_per_tick")
    if ms is None or bound is None:
        return None
    return 100.0 * bound / ms
