"""Afterpulse test inputs shared by the CPU tests (against wfsim_tpu) and
the card-only tests; numpy only, so the card's machine needs no JAX."""
import numpy as np

from wfsim_tpu_torch.resources.synthetic import synthetic_pmt_ap_cdfs

N_CH = 494
N_ROWS = 8


def ap_tables():
    """The synthetic two-species tables plus a uniform element, so both
    branches of the generator run (element order: Ar, He, Uniform)."""
    tables = synthetic_pmt_ap_cdfs(N_CH)
    tables['Uniform'] = dict(delaytime_cdf=np.tile([0.002, 0.004], (N_CH, 1)),
                             amplitude_cdf=np.array([1.0]),
                             delaytime_bin_size=1e6,
                             amplitude_bin_size=0.01)
    return tables


def photon_set(seed, n):
    """Primary photons with invalid and double-PE photons, grouped by
    truth row."""
    rng = np.random.default_rng(seed)
    ch = rng.integers(-1, N_CH, n).astype(np.int32)
    valid = (ch >= 0) & (rng.random(n) < 0.95)
    return dict(t=rng.integers(0, 1_000_000, n).astype(np.int32),
                ch=np.where(valid, ch, -1).astype(np.int32),
                is_dpe=rng.random(n) < 0.2, valid=valid,
                truth_row=np.sort(rng.integers(0, N_ROWS, n)))
