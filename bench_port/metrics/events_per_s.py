"""Events whose truth and records the caller holds, over the window."""


def read(ctx):
    return ctx['events'] / ctx['window_s']
