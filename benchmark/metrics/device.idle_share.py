"""Share of the traced window in which no kernel or copy ran on the device
(percent): 100 x (1 - union of device intervals / window)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or tr.n_device_events == 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
