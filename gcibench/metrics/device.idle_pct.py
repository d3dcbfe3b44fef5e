"""The share of the traced window in which no kernel, copy or memset ran
on the card."""
UNIT = "%"


def read(run):
    if run.trace is None or not run.trace.device_events or run.trace.window_s <= 0:
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)
