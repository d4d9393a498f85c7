"""Host ms per 1,000 delivered events in the physics passes and the
afterpulses, their read-back waits included."""
from bench_port.readers import ms_per_kevent

PHASES = ('simulate_s1', 'simulate_s2', 'simulate_pi_el', 'simulate_pe_el',
          'pmt_afterpulses', 'electron_afterpulses')


def read(ctx):
    return ms_per_kevent(ctx, *PHASES)
