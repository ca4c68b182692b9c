"""The share of the traced window in which nothing ran on the card: one less
the union of its kernel, copy and set intervals over the window."""


def read(bundle, _kind):
    trace = bundle.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
