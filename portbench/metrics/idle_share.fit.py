"""idle_share.fit: percent of one whole traced fit in which no operation
ran on the card: 1 - (union of the device intervals) / wall time."""
UNIT = "%"


def read(run):
    t = run.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
