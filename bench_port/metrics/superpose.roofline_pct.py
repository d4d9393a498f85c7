"""The superposition kernels' (K1+K2 slim and full, K10) share of their
roofline over the traced calls."""
from bench_port.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, 'superpose')
