"""idle_share.replay: the share of the traced window (from its first
device operation to its last) in which no operation ran on the device
(%)."""


def read(r):
    if not r.ops or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
