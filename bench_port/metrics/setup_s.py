"""Seconds from the process's start to the window's start."""


def read(ctx):
    return ctx['setup_s']
