"""idle_share: the share of a round in which no operation runs on the
device: one minus the device's busy time a round, the union of the
traced stretch's device intervals over its rounds, over the measured
window's wall time a round. The window, not the traced stretch, is the
denominator: tracing each kernel slows a round that the host paces, and
its start stalls a short stretch. Where the busy time a round exceeds
the window's round (the trace's own stretch of a kernel, in a round the
card paces whole), the device never idles: 0."""

UNIT = "%"
LAYER = "device"
MOVES = "round_ms"


def read(run):
    tr = run.trace
    if not tr or not run.rounds:
        return None
    busy = tr["busy_s"] / tr["rounds"]
    return 100.0 * max(0.0, 1.0 - busy / (run.window_s / run.rounds))
