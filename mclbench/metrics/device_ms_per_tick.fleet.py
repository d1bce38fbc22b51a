"""device_ms_per_tick.fleet: the device's busy time a fleet frame (ms),
the union of every device operation's interval over the traced frames."""


def read(r):
    return r.ms_per_tick()
