"""The plain reference of the physics passes, from the truth rows.

Plain NumPy; it imports nothing of the program.  Each number is a |z| of
a total the program delivered against its expectation from the
instructions and the configuration (upstream XENONnT/WFSim ``core/s1.py``,
``core/s2.py``, ``core/afterpulse.py``, ``core/pulse.py``):

* ``s1_photons_z``: S1 detected photons, Binomial(amp, LCE / (1 + p_dpe)
  x efficiency), the LCE the constant S1 pattern summed over the PMTs;
* ``s2_electrons_z``: S2 electrons, Binomial(amp, extraction x
  exp(-drift time / lifetime));
* ``s2_photons_z``: S2 photons, Poisson(secondary scintillation gain /
  (1 + p_dpe) an electron);
* ``electron_time_z``: each S2 row's mean electron arrival time against
  the drift time, the gate's drift time and the mean trapping delay
  (the times truncated to whole ns);
* ``electron_spread_z``: each S2 row's variance of electron arrival times
  against longitudinal diffusion (2 D t / v^2) and trapping;
* ``pmt_ap_z``: in the compared digitize batches, the photons the
  digitizer received beyond the truth rows' own, against the afterpulses
  the delay-time CDFs give each photoelectron;
* ``ele_ap_z``: the electrons of the photoionization rows (type 4)
  against those the S2 photons seed (electrons a photon x the survival of
  each delay, coarse-binned as upstream ``afterpulse.py:63-80``).

The resource tables are made here from the recipes the configuration
file states (copies of the synthetic assets' recipes), never read from
the program.
"""
from __future__ import annotations

import math

import numpy as np

#: S2 rows with fewer electrons are left out of the time numbers
MIN_ELECTRONS = 10
#: rows and sources later than this before the stream's delivered end are
#: left out (ns)
TAIL_NS = 5_000_000


# ---------------------------------------------------------------------------
# resource recipes (copies of the program's synthetic assets)


def pmt_ap_elements(n_channels: int, p_ap: float = 0.025) -> dict:
    """The synthetic PMT-afterpulse description: per ion species the
    delay-time CDF (its last value the afterpulse probability of a
    photoelectron), the amplitude CDF and the bin sizes."""
    out = {}
    specs = [('He', 0.55 * p_ap, 600.0, 150.0),
             ('Ar', 0.45 * p_ap, 2200.0, 400.0)]
    t = np.arange(4000.0)
    for name, prob, mu, sig in specs:
        cdf1 = prob * 0.5 * (1 + np.tanh((t - mu) / (np.sqrt(2) * sig)))
        amp = np.arange(400) / 100.0
        amp_pdf = np.exp(-0.5 * ((amp - 1.0) / 0.45) ** 2)
        out[name] = dict(delaytime_cdf=np.tile(cdf1, (n_channels, 1)),
                         amplitude_cdf=np.cumsum(amp_pdf) / amp_pdf.sum(),
                         delaytime_bin_size=1.0, amplitude_bin_size=0.01)
    return out


def ele_ap_pmf(rate_per_photon: float = 5e-4, n_bins: int = 200,
               t_max: float = 1.0e6):
    """The synthetic photoionization delay PMF: (electrons a detected
    photon, bin centres, CDF over them)."""
    bc = np.linspace(1000.0, t_max, n_bins)
    pmf = 1.0 / bc
    pmf /= pmf.sum()
    cdf = np.cumsum(pmf)
    return float(rate_per_photon), bc, cdf / cdf[-1]


# ---------------------------------------------------------------------------
# expectations


def _dummy_value(entry, name: str) -> float:
    """A ``['constant dummy', value, shape]`` map's value x the size of its
    last axis (its sum over the PMTs)."""
    if not (isinstance(entry, list) and entry
            and entry[0] == 'constant dummy'):
        raise NotImplementedError(f'{name}: only constant dummy maps')
    shape = entry[2] if len(entry) > 2 else []
    return float(entry[1]) * (float(shape[-1]) if shape else 1.0)


def drift_time(cfg: dict, z) -> np.ndarray:
    """Mean drift time (ns) from depth ``z``: ``-z / v`` plus the gate's,
    at least 0 (upstream s2.py:157-179)."""
    return np.maximum(-np.asarray(z, np.float64)
                      / cfg['drift_velocity_liquid']
                      + cfg['drift_time_gate'], 0.0)


def s2_electron_probability(cfg: dict, z) -> np.ndarray:
    """An electron's probability to reach the gas and be extracted
    (upstream s2.py:211-256)."""
    return (cfg['electron_extraction_yield']
            * np.exp(-drift_time(cfg, z) / cfg['electron_lifetime_liquid']))


def s2_photons_per_electron(cfg: dict) -> float:
    """Mean detected photons an extracted electron makes (upstream
    s2.py:181-209; the S2 correction map constant)."""
    corr = _dummy_value(cfg['s2_correction_map'], 's2_correction_map')
    return corr * cfg['s2_secondary_sc_gain'] / (1 + cfg['p_double_pe_emision'])


def s1_photon_probability(cfg: dict) -> float:
    """A quantum's probability to be a detected S1 photon (upstream
    s1.py:116-135): the LCE (the S1 pattern summed over the PMTs) over
    1 + p_dpe, times the detection efficiency."""
    if cfg.get('s1_lce_correction_map'):
        raise NotImplementedError('s1_lce_correction_map')
    lce = _dummy_value(cfg['s1_pattern_map'], 's1_pattern_map')
    return (lce / (1 + cfg['p_double_pe_emision'])
            * cfg['s1_detection_efficiency'])


def pmt_ap_per_pe(cfg: dict, elements: dict) -> float:
    """Expected PMT afterpulses a photoelectron (upstream
    afterpulse.py:143-249): per species the delay CDF's last value times
    ``pmt_ap_modifier`` (a double-PE photon draws against twice it), and
    for a species with an amplitude CDF the chance that its amplitude is
    not the zeroth bin."""
    total = 0.0
    for el in elements.values():
        c = float(np.float32(np.asarray(el['delaytime_cdf'])[..., -1].mean()))
        a = np.asarray(el['amplitude_cdf'], np.float32)
        q = 1.0 - (float(a[0]) + float(a[1])) / 2 if len(a) >= 2 else 0.0
        total += c * cfg['pmt_ap_modifier'] * q
    return total


def coarse_delays(cfg: dict, bc: np.ndarray) -> np.ndarray:
    """The diffusion-matched coarse delay grid photoionization electrons
    are binned on (upstream afterpulse.py:63-80)."""
    spread = (np.sqrt(2 * cfg['diffusion_constant_longitudinal'] * bc)
              / cfg['drift_velocity_liquid'])
    grid, ct = [], 100.0
    while ct < bc[-1]:
        grid.append(ct)
        ct += spread[np.argmin(np.abs(ct - bc))]
    return np.asarray(grid)


def _ele_ap_delays(cfg: dict, pmf, n_points: int):
    """The photoionization delays at ``n_points`` quantiles of the PMF
    that fall below the coarse grid's end, each on its coarse bin, and the
    survival of an electron drifting it (its instruction's z is float32)."""
    _rate, bc, cdf = pmf
    u = (np.arange(n_points) + 0.5) / n_points
    d = np.interp(u, cdf, bc)
    coarse = coarse_delays(cfg, bc)
    d = d[d < coarse[-1]]
    delay = coarse[np.clip(np.digitize(d, coarse), 0, len(coarse) - 1)]
    z = (-delay * cfg['drift_velocity_liquid']).astype(np.float32)
    return delay, s2_electron_probability(cfg, z)


def ele_ap_electrons_per_photon(cfg: dict, pmf, n_points: int = 2_000_000):
    """Expected photoionization electrons a detected S2 photon leaves in
    the truth: the PMF's rate x ``photoionization_modifier`` x the mean,
    over the delay, of (delay below the coarse grid's end) x the survival
    of an electron drifting its coarse delay."""
    _delay, p = _ele_ap_delays(cfg, pmf, n_points)
    return pmf[0] * cfg['photoionization_modifier'] * float(p.sum()) / n_points


def ele_ap_mean_lag(cfg: dict, pmf, n_points: int = 200_000) -> float:
    """Mean time (ns) from an S2 row's first photon to the first photon of
    a photoionization row it seeds, weighted as its electrons are: the
    coarse delay, over the electrons that survive it."""
    delay, p = _ele_ap_delays(cfg, pmf, n_points)
    return float((delay * p).sum() / max(p.sum(), 1e-30))


# ---------------------------------------------------------------------------
# the numbers


def row_keys(a: np.ndarray) -> np.ndarray:
    """One byte key per instruction or truth row: type, amp, x, y, z."""
    k = np.zeros(len(a), dtype=[('type', 'i1'), ('amp', 'i8'), ('x', 'f4'),
                                ('y', 'f4'), ('z', 'f4')])
    for f in k.dtype.names:
        k[f] = a[f]
    return k.view(np.dtype((np.void, k.dtype.itemsize)))


def instruction_times(inst: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """The time of each truth row's instruction (the truth's own ``time``
    is its first photon's), found by its key; -1 where none matches."""
    keys = row_keys(inst)
    order = np.argsort(keys)
    k = np.searchsorted(keys[order], row_keys(rows))
    k = np.clip(k, 0, len(order) - 1)
    hit = keys[order][k] == row_keys(rows)
    return np.where(hit, inst['time'][order][k], -1)


def _z(obs: float, mean: float, var: float) -> float:
    return abs(obs - mean) / math.sqrt(max(var, 1e-30))


def physics_numbers(cfg: dict, truth: np.ndarray, end_ns: int,
                    inst: np.ndarray, *, elements: dict | None = None,
                    pmf=None, ap_batches=()) -> dict:
    """The |z| of each physics number (see the module's docstring) and the
    totals they compare.  ``inst`` is the instruction stream; ``elements``
    and ``pmf`` are the PMT- and electron-afterpulse tables (None where
    that effect is off); ``ap_batches`` holds (photons received, truth
    rows' photons, their photoelectrons) of each compared digitize
    batch."""
    out = {}
    horizon = end_ns - TAIL_NS

    s1 = truth[truth['type'] == 1]
    p1 = s1_photon_probability(cfg)
    amp = s1['amp'].astype(np.float64)
    obs = float(s1['n_photon'].astype(np.float64).sum())
    out['s1_photons_z'] = _z(obs, p1 * amp.sum(), (amp * p1 * (1 - p1)).sum())
    out['s1_photons'] = obs

    s2 = truth[truth['type'] == 2]
    amp = s2['amp'].astype(np.float64)
    p = s2_electron_probability(cfg, s2['z'])
    n_e = s2['n_electron'].astype(np.float64)
    n_ph = s2['n_photon'].astype(np.float64)
    out['s2_electrons_z'] = _z(n_e.sum(), (amp * p).sum(),
                               (amp * p * (1 - p)).sum())
    lam = s2_photons_per_electron(cfg)
    out['s2_photons_z'] = _z(n_ph.sum(), lam * n_e.sum(), lam * n_e.sum())
    out['s2_rows'] = len(s2)
    out['electrons'] = float(n_e.sum())
    out['photons'] = float(n_ph.sum())

    # electron arrival times: trunc(mean + trapping x Exp + spread x N)
    rows = s2[s2['n_electron'] >= MIN_ELECTRONS]
    t_inst = instruction_times(inst[inst['type'] == 2], rows)
    rows, t_inst = rows[t_inst >= 0], t_inst[t_inst >= 0]
    n = rows['n_electron'].astype(np.float64)
    m = drift_time(cfg, rows['z'])
    v = cfg['drift_velocity_liquid']
    s2_ = 2 * cfg['diffusion_constant_longitudinal'] * m / v ** 2
    th2 = float(cfg['electron_trapping_time']) ** 2
    var = s2_ + th2 + 1 / 12
    r = (rows['t_mean_electron'] - t_inst.astype(np.float64)
         - (m + cfg['electron_trapping_time'] - 0.5))
    zt = r / np.sqrt(var / n)
    out['electron_time_z'] = (abs(float(zt.sum())) / math.sqrt(len(zt))
                              if len(zt) else 0.0)
    mu4 = 3 * s2_ ** 2 + 6 * s2_ * th2 + 9 * th2 ** 2
    sv = rows['t_sigma_electron'].astype(np.float64) ** 2
    zs = (sv - var * (n - 1) / n) / np.sqrt((mu4 - (s2_ + th2) ** 2) / n)
    out['electron_spread_z'] = (abs(float(zs.sum())) / math.sqrt(len(zs))
                                if len(zs) else 0.0)
    out['time_rows'] = len(rows)
    out['time_rows_unmatched'] = int(len(s2[s2['n_electron'] >= MIN_ELECTRONS])
                                     - len(rows))

    if elements is not None:
        per_pe = pmt_ap_per_pe(cfg, elements)
        got = sum(float(b[0] - b[1]) for b in ap_batches)
        want = per_pe * sum(float(b[2]) for b in ap_batches)
        out['pmt_ap_z'] = _z(got, want, want) if ap_batches else 0.0
        out['pmt_afterpulses'] = got
    if pmf is not None:
        # the truth's time is a row's first photon
        src = s2[s2['time'] < horizon]
        lag = ele_ap_mean_lag(cfg, pmf)
        pi = truth[(truth['type'] == 4) & (truth['time'] < horizon + lag)]
        want = (ele_ap_electrons_per_photon(cfg, pmf)
                * float(src['n_photon'].astype(np.float64).sum()))
        got = float(pi['n_electron'].astype(np.float64).sum())
        out['ele_ap_z'] = _z(got, want, want)
        out['ele_ap_electrons'] = got
    return out


def control_truth(cfg: dict, truth: np.ndarray, seed: int) -> np.ndarray:
    """The S2 truth rows drawn by the reference in the program's place,
    with the probabilities and the photon yield rounded to bfloat16: the
    physics control (``s2_photons_z``, ``s2_electrons_z``)."""
    import torch
    s2 = truth[truth['type'] == 2].copy()
    gen = torch.Generator().manual_seed(int(seed))
    p = torch.as_tensor(s2_electron_probability(
        cfg, np.ascontiguousarray(s2['z'])),
                        dtype=torch.float64).to(torch.bfloat16).to(
        torch.float64)
    n_e = torch.binomial(torch.as_tensor(np.ascontiguousarray(s2['amp']),
                                         dtype=torch.float64), p,
                         generator=gen)
    lam = torch.tensor(s2_photons_per_electron(cfg)).to(torch.bfloat16).to(
        torch.float64)
    n_ph = torch.poisson(n_e * lam, generator=gen)
    s2['n_electron'] = n_e.numpy().astype(np.int64)
    s2['n_photon'] = n_ph.numpy().astype(np.int64)
    return s2
