"""idle_share.descent: percent of STEPS traced descent steps, from the
window's last state, in which no operation ran on the card."""
UNIT = "%"
STEPS = 20


def read(run):
    t = run.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
