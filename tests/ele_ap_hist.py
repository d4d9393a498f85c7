"""An electron-afterpulse delay histogram shaped like the reference's
``ele_ap_pdfs`` object, a multihist ``Hist1d``: ``histogram``,
``bin_edges``, ``bin_centers``, ``n`` and ``get_random(size, rng=)``,
which draws a bin by its weight and a point uniform within it.  Its
pickles name this module, so wfsim_tpu and wfsim_tpu_torch unpickle the
same class (tests/test_torch_surface_gaps.py)."""
import numpy as np


class DelayHist1d:
    def __init__(self, bin_edges, histogram, n):
        self.bin_edges = np.asarray(bin_edges, dtype=np.float64)
        self.histogram = np.asarray(histogram, dtype=np.float64)
        self.n = float(n)

    @property
    def bin_centers(self):
        return 0.5 * (self.bin_edges[1:] + self.bin_edges[:-1])

    def get_random(self, size=10, rng=None):
        rng = rng or np.random.default_rng()
        p = self.histogram / self.histogram.sum()
        i = rng.choice(len(p), size=size, p=p)
        return self.bin_edges[i] + rng.random(size) * np.diff(
            self.bin_edges)[i]


def delay_hist(seed=5, n_bins=120):
    """A falling delay spectrum over 1 us to 1 ms, 5e-3 electrons a
    photon (ten times the synthetic PMF's, so a few S2s give pi_el
    instructions)."""
    rng = np.random.default_rng(seed)
    edges = np.geomspace(1_000.0, 1_000_000.0, n_bins + 1)
    weights = 1.0 / edges[:-1] * rng.uniform(0.5, 1.5, n_bins)
    return DelayHist1d(edges, weights, 5e-3)
