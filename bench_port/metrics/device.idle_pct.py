"""100 - the device's busy share of the traced span (the union of every
kernel and copy record of the profiler)."""


def read(ctx):
    tr = ctx['trace']
    if not tr or tr['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - tr['busy_s'] / tr['window_s'])
