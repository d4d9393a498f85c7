"""Host ms per 1,000 delivered events in the record collection (each
round's copy into the record arena and its wait)."""
from bench_port.readers import ms_per_kevent


def read(ctx):
    return ms_per_kevent(ctx, 'digitize_host_records')
