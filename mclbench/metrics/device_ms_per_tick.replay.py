"""device_ms_per_tick.replay: the device's busy time a filter tick of a
replay (ms), the union of every device operation's interval over the
traced segments, over their ticks."""


def read(r):
    return r.ms_per_tick()
