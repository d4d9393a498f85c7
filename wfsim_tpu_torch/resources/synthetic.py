"""Synthetic detector-response assets.

The reference downloads measured calibration files (SPE charge spectra, PMT
afterpulse CDFs, electron-afterpulse delay PMFs, real noise traces) from
XENON-internal repositories (reference: wfsim/load_resource.py:62-127).
Those are not redistributable; this module generates physically-shaped
synthetic stand-ins so the full simulation chain runs hermetically.  Real
files, when available locally, take precedence (see loader.py).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    'synthetic_spe_distribution', 'synthetic_noise', 'synthetic_pmt_ap_cdfs',
    'synthetic_ele_ap_pmf', 'synthetic_garfield_gas_gap',
]


def synthetic_spe_distribution(n_channels: int, n_bins: int = 200,
                               mean: float = 1.0, width: float = 0.4):
    """Gaussian-ish SPE charge spectrum per channel, in the same tabular form
    as the reference's SPE CSV: a 'charge' axis plus one pdf column/channel."""
    charge = np.linspace(-0.995, 2.995, n_bins)
    pdf = np.exp(-0.5 * ((charge - mean) / width) ** 2)
    pdf[charge <= 0.05] = 0.0
    pdf /= pdf.sum()
    return charge, np.tile(pdf, (n_channels, 1))


def synthetic_noise(n_channels: int, length: int = 100000,
                    sigma_adc: float = 2.3, seed: int = 1234):
    """Stationary Gaussian electronics noise with a mild 1/f-ish low-frequency
    component, as integer ADC counts, shaped like the reference noise bank
    (length, n_channels)."""
    rng = np.random.default_rng(seed)
    white = rng.normal(0, sigma_adc, (length, n_channels))
    slow = rng.normal(0, sigma_adc / 2, (length // 100 + 2, n_channels))
    idx = np.linspace(0, slow.shape[0] - 1.001, length)
    i0 = idx.astype(int)
    w = (idx - i0)[:, None]
    drift = slow[i0] * (1 - w) + slow[i0 + 1] * w
    return np.round(white + drift).astype(np.int64)


def synthetic_pmt_ap_cdfs(n_channels: int, p_ap: float = 0.025):
    """PMT afterpulse description in the reference's ``uniform_to_pmt_ap``
    schema (element -> delaytime_cdf (n_ch, n_t), amplitude_cdf, bin sizes;
    see reference wfsim/core/afterpulse.py:171-243).

    Two ion species with distinct delay scales, plus a small uniform tail.
    The delaytime CDF is intentionally NOT normalized to 1 — its last column
    is the per-channel afterpulse probability.

    Magnitude: the default total AP probability (2.5% per detected photon,
    summed over species) matches the measured scale of the R11410-21 tubes
    XENONnT uses — qualification measurements report per-ion afterpulse
    rates summing to a few percent per photoelectron, with a <10%
    acceptance cut (Barrow et al., JINST 12 (2017) P01024,
    arXiv:1609.01654; the reference ships per-channel measured CDFs with
    the same normalization convention, afterpulse.py:192-204).  See
    PARITY.md "Synthetic asset magnitudes".
    """
    out = {}
    specs = [('He', 0.55 * p_ap, 600.0, 150.0), ('Ar', 0.45 * p_ap, 2200.0, 400.0)]
    t = np.arange(4000.0)
    for name, prob, mu, sig in specs:
        cdf1 = prob * 0.5 * (1 + np.tanh((t - mu) / (np.sqrt(2) * sig)))
        delaytime_cdf = np.tile(cdf1, (n_channels, 1))
        amp = np.arange(400) / 100.0  # amplitude axis in PE
        amp_pdf = np.exp(-0.5 * ((amp - 1.0) / 0.45) ** 2)
        amplitude_cdf = np.cumsum(amp_pdf) / amp_pdf.sum()
        out[name] = dict(delaytime_cdf=delaytime_cdf,
                         amplitude_cdf=amplitude_cdf,
                         delaytime_bin_size=1.0,
                         amplitude_bin_size=0.01)
    return out


def synthetic_ele_ap_pmf(rate_per_photon: float = 5e-4,
                         n_bins: int = 200, t_max: float = 1.0e6):
    """Photoionization delay-time PMF histogram in the shape the reference's
    ``uniform_to_ele_ap`` object exposes: attributes ``n`` (expected electrons
    per detected photon), ``bin_centers`` and a ``get_random`` sampler
    (reference: wfsim/core/afterpulse.py:33-51).

    Magnitude: delayed-electron studies in LXe TPCs attribute a
    photoionization yield of order 1e-4..1e-3 electrons per S2 photon
    (purity-dependent) — Sorensen & Kamdin, JINST 13 (2018) P02032,
    arXiv:1711.07025; XENON1T electron-emission analysis,
    arXiv:2112.12116.  The default adopts 5e-4 as a representative
    mid-scale (the reference's measured PMF carries its own ``n``).  See
    PARITY.md "Synthetic asset magnitudes"."""
    bin_centers = np.linspace(1000.0, t_max, n_bins)
    pmf = 1.0 / bin_centers  # ~1/t tail, as observed for photoionization
    pmf /= pmf.sum()
    return DelayTimePMF(rate_per_photon, bin_centers, pmf)


class DelayTimePMF:
    """Minimal histogram-PMF sampler (duck-typed to the reference's
    multihist-based afterpulse delay object)."""

    def __init__(self, n, bin_centers, pmf):
        self.n = float(n)
        self.bin_centers = np.asarray(bin_centers, dtype=np.float64)
        self.pmf = np.asarray(pmf, dtype=np.float64)
        self.cdf = np.cumsum(self.pmf)
        self.cdf /= self.cdf[-1]

    def get_random(self, size, rng=None):
        rng = rng or np.random.default_rng()
        u = rng.random(size)
        return np.interp(u, self.cdf, self.bin_centers)


def synthetic_garfield_gas_gap(n_gaps: int = 10, inv_cdf_len: int = 1000):
    """Garfield gas-gap luminescence timing table in the reference's
    ``s2_luminescence_gg`` schema: per gas-gap inverse CDFs of the excitation
    time (reference: wfsim/core/s2.py:459-483).

    Synthetic model: photon emission uniform over the electron transit of the
    gas gap, with transit time proportional to gap.
    """
    gas_gap = np.linspace(0.05, 0.05 + 0.01 * (n_gaps - 1), n_gaps)  # cm
    q = np.linspace(0, 1, inv_cdf_len)
    transit_ns = gas_gap / 0.0008  # ~ gap / gas drift speed
    inv_cdf = np.stack([t * (q ** 0.8) for t in transit_ns])
    return {
        'gas_gap': gas_gap,
        'timing_inv_cdf': inv_cdf.astype(np.float64),
    }
