"""Tabulated NEST scintillation photon-time distributions (the port's copy
of wfsim_tpu/resources/nest_tables.py, host numpy; the same generator calls
in the same order, so the tables are bit for bit the JAX package's).

The reference's ``nest`` S1 timing mode calls the C++ nestpy library
per-instruction inside a Python loop (reference: wfsim/core/s1.py:217-234).
That is host-bound and unbatchable, so this framework tabulates the photon
emission-time distribution ONCE per configuration as inverse CDFs on a
(recoil-class, field, energy) grid and samples them on device — statistically
equivalent, and exact in the limit of grid density.

Table generation uses nestpy when importable; otherwise an analytic
singlet/triplet + field-dependent recombination mixture with the same shape
as NEST's ER/NR timing model.

Error bound (measured on the JAX package's copy,
tests/test_resources.py::test_nest_table_convergence):
on the default 16x16 log grid with 2048 quantiles, the sampled-time mean,
median and IQR at off-grid (field, energy) points agree with direct sampling
of the underlying generator to better than 2.5% of the distribution's
standard deviation (mean) / 3% of the IQR (median, IQR, q99), and doubling
the grid in both axes moves them by less than those same bounds — i.e. the
default grid is converged at the percent level.  The standard deviation
itself is dominated by the top ~0.3% recombination tail and fluctuates
+-5% with the table's build-sample count; use quantile-based dispersion
when validating.  Tables are memoised per (generator, grid,
max-recombination-time) so repeated ``build_params`` calls reuse them.
"""
from __future__ import annotations

import numpy as np

__all__ = ['build_nest_timing_tables', 'NEST_RECOIL_CLASSES']

# recoil-class order in the table's leading axis
NEST_RECOIL_CLASSES = ('er', 'nr', 'alpha', 'led')
_CLS_OF_NESTID = {0: 1, 6: 2, 7: 0, 8: 0, 11: 0, 12: 0, 20: 3}

# default (field, energy) support: log-spaced, spanning the XENONnT drift
# fields (tens to hundreds of V/cm) and the keV..hundreds-keV energy range
DEFAULT_FIELDS = tuple(np.geomspace(10.0, 1000.0, 16))
DEFAULT_ENERGIES = tuple(np.geomspace(0.3, 300.0, 16))

_TABLE_CACHE: dict = {}


def recoil_class_index(recoil_ids: np.ndarray) -> np.ndarray:
    out = np.zeros(len(recoil_ids), dtype=np.int32)
    for rid, cls in _CLS_OF_NESTID.items():
        out[recoil_ids == rid] = cls
    return out


# LXe excimer decay constants, NEST v2 (NEST.cpp PhotonTime; measured in
# arXiv:1802.06162): singlet 3.27 ns, triplet 23.97 ns
NEST_TAU_SINGLET = 3.27
NEST_TAU_TRIPLET = 23.97


def _exciton_photon_fraction(cls: int, field: float, energy: float) -> float:
    """Fraction of emitted photons coming from direct excitons (the rest are
    recombination photons), from the same quanta partition the instruction
    generator uses (interface/instructions.py analytic_yields): photons =
    n_ex + r * n_i, so f_ex = n_ex / photons.  Only the ER class uses it —
    NEST gives NR/ion photons a zero recombination time, making the split
    timing-irrelevant there."""
    from ..interface.instructions import analytic_yields

    n_ph, _n_el, n_ex = analytic_yields(energy, max(field, 1.0),
                                        7 if cls == 0 else 0)
    return min(n_ex / max(n_ph, 1), 1.0)


def _nest_photon_times(cls: int, field: float, energy: float,
                       n: int, rng) -> np.ndarray:
    """NEST v2 LXe photon emission-time model (pure-python rendition of
    nestpy's ``GetPhotonTimes``/``PhotonTime``; used when nestpy itself is
    not importable).

    Formulas and constants from the NEST v2 code (NEST.cpp PhotonTime) and
    its references:

    - excimer lifetimes: tau_singlet = 3.27 ns, tau_triplet = 23.97 ns
      (arXiv:1802.06162);
    - singlet/triplet photon ratio R:
        NR:            R = 0.15 * E^0.15
        ion (alpha):   R = 0.065 * E^0.416
        ER, recombination photons: R = 0.069539 * E^-0.12244
        ER, exciton photons:       R = 0.013885 * E^0.21086
      (power-law fits compiled in arXiv:1802.06162);
    - ER recombination time  tau_R = exp(-0.00900 * field) *
      (7.3138 + 3.8431 * log10(E)) ns (field in V/cm, E in keV; NEST's fit
      to the data of arXiv:1310.1117), zero for exciton photons and for
      NR/ion tracks;
    - per-photon delay = tau_R * (1/u - 1)   [u ~ U(0,1); the 1/u-1 kernel
      is NEST's heavy-tailed recombination delay] + Exp(tau_singlet) or
      Exp(tau_triplet) with probability R/(1+R).

    The 'led' class keeps the reference's uniform window
    (wfsim/core/s1.py:272-279) — LED light is not scintillation.
    """
    if cls == 3:      # LED: uniform pulse window
        return rng.uniform(0, 100.0, n)
    E = max(float(energy), 1e-3)
    if cls == 1:      # NR
        ratio = np.full(n, 0.15 * E ** 0.15)
        tau_r = np.zeros(n)
    elif cls == 2:    # alpha / ion
        ratio = np.full(n, 0.065 * E ** 0.416)
        tau_r = np.zeros(n)
    else:             # ER: exciton vs recombination photon split
        f_ex = _exciton_photon_fraction(cls, field, E)
        is_ex = rng.random(n) < f_ex
        ratio = np.where(is_ex,
                         0.013885 * E ** 0.21086,
                         0.069539 * E ** -0.12244)
        tau_er = max(np.exp(-0.00900 * field)
                     * (7.3138 + 3.8431 * np.log10(E)), 0.0)
        tau_r = np.where(is_ex, 0.0, tau_er)
    u = rng.uniform(1e-12, 1.0, n)
    delay = tau_r * (1.0 / u - 1.0)
    singlet = rng.random(n) < ratio / (1.0 + ratio)
    tau = np.where(singlet, NEST_TAU_SINGLET, NEST_TAU_TRIPLET)
    return delay + rng.exponential(1.0, n) * tau


def build_nest_timing_tables(config,
                             fields=DEFAULT_FIELDS,
                             energies=DEFAULT_ENERGIES,
                             m_quantiles: int = 2048,
                             n_samples: int = 100_000,
                             seed: int = 42):
    """(inv_cdf [4, F, E, M], fields [F], energies [E]) float32 arrays.

    Memoised on (nestpy availability, grid, m_quantiles, n_samples, seed,
    maximum_recombination_time): the grid build costs
    4 * F * E * n_samples draws, and every parameter build with 'nest' in
    s1_model_type calls this.
    """
    try:
        import nestpy
        calc = nestpy.NESTcalc(nestpy.DetectorExample_XENON10())
    except ImportError:
        calc = None

    max_t = float(config.get('maximum_recombination_time', 10000.0))
    cache_key = (calc is not None, tuple(fields), tuple(energies),
                 m_quantiles, n_samples, seed, max_t)
    hit = _TABLE_CACHE.get(cache_key)
    if hit is not None:
        return hit

    rng = np.random.default_rng(seed)
    q = np.linspace(0, 1, m_quantiles)
    F, E = len(fields), len(energies)
    table = np.zeros((len(NEST_RECOIL_CLASSES), F, E, m_quantiles), np.float32)

    nest_ids = {'er': 7, 'nr': 0, 'alpha': 6, 'led': 20}
    for ci, cls_name in enumerate(NEST_RECOIL_CLASSES):
        for fi, field in enumerate(fields):
            for ei, energy in enumerate(energies):
                if calc is not None and cls_name != 'led':
                    # Estimate quanta for GetPhotonTimes inputs
                    itp = nestpy.INTERACTION_TYPE(nest_ids[cls_name])
                    y = calc.GetYields(itp, energy, 2.862, field, 131.293, 54.)
                    qq = calc.GetQuanta(y, 2.862)
                    times = np.asarray(calc.GetPhotonTimes(
                        itp, max(qq.photons, 100), qq.excitons, field, energy))
                else:
                    times = _nest_photon_times(
                        ci, field, energy, n_samples, rng)
                times = np.clip(times, 0, max_t)
                table[ci, fi, ei] = np.quantile(times, q)
    out = (table,
           np.asarray(fields, np.float32),
           np.asarray(energies, np.float32))
    _TABLE_CACHE[cache_key] = out
    return out
