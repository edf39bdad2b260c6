"""The device's idle share of the traced sub-window: 1 - the union of its
operations' intervals / the sub-window, in %."""


def read(run):
    d = run.digest
    if d is None or d.window_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)
