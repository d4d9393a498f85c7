"""Host ms per 1,000 delivered events in the digitize plan (windows, the
photon arena, the batches)."""
from bench_port.readers import ms_per_kevent


def read(ctx):
    return ms_per_kevent(ctx, 'digitize_plan')
