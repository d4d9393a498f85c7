"""Host ms per 1,000 delivered events in the digitize batches (the phase
ends in a read-back)."""
from bench_port.readers import ms_per_kevent


def read(ctx):
    return ms_per_kevent(ctx, 'digitize_batches')
