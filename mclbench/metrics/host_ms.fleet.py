"""host_ms.fleet: the servers' host time a fleet frame (ms): the mean time
from a frame's line handed to `serve` to its reply written, over the
traced run's frames outside the profile, less the device's busy time a
frame in the profile."""


def read(r):
    dev = r.ms_per_tick()
    if not r.service_ms or dev is None:
        return None
    return sum(r.service_ms) / len(r.service_ms) - dev
