"""Host ms per 1,000 delivered events in the chunker's final passes
(records, truth, the raw_records / _he / _aqmon split)."""
from bench_port.readers import ms_per_kevent


def read(ctx):
    return ms_per_kevent(ctx, 'chunker_final')
