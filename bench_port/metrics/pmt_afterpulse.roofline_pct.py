"""The PMT-afterpulse kernels' (K11 select, rows, emit) share of their
roofline over the traced calls."""
from bench_port.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, 'pmt_afterpulse')
