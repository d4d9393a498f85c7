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
    'write_pattern_map', 'write_production_files', 'PRODUCTION_FILES',
    'synthetic_garfield_table', 'write_garfield_table', 'GARFIELD_LEVELS',
    'write_field_maps', 'FIELD_MAP_FILES', 'SyntheticG4File',
    'synthetic_g4_file', 'synthetic_nv_pmt_qe',
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


def synthetic_garfield_table(seed: int, n_rows: int = 11,
                             n_cols: int = 500):
    """A ``garfield`` wire-distance luminescence table in the shape of
    wfsim_tpu's test table (tests/test_models.py:232-236): ``x`` the
    distances from the wire, ``n_rows`` points on [-0.25, 0.25] cm, and
    ``t`` (n_rows, n_cols) float32 times, exponential(300 ns) plus 1000 ns
    per cm of |x|.  Returns ``{'t', 'x'}``; a test asset, not a
    simulation of the anode."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-0.25, 0.25, n_rows)
    t = rng.exponential(300, (n_rows, n_cols)) + np.abs(x)[:, None] * 1000
    return {'t': t.astype(np.float32), 'x': x.astype(np.float32)}


#: the liquid levels (cm) of :func:`write_garfield_table`'s file and the
#: factor each level's times carry: the default configuration's level,
#: gate_to_anode_distance - elr_gas_gap_length = 0.234 cm, holds
#: :func:`synthetic_garfield_table` itself
GARFIELD_LEVELS = ((0.18, 0.8), (0.234, 1.0), (0.29, 1.25))


def write_garfield_table(path, seed: int):
    """Write a ``garfield`` table file to ``path`` (npz, ``arr_0``): a
    structured array with fields ``ll`` (float64), ``x`` (float32) and
    ``t`` (float32, (M,)), one block of rows per liquid level of
    :data:`GARFIELD_LEVELS`, each :func:`synthetic_garfield_table` with its
    times scaled by the level's factor, so the loader's row selection by
    ``ll`` is seen in the times.  Returns the path."""
    tbl = synthetic_garfield_table(seed)
    R, M = tbl['t'].shape
    dtype = [('ll', np.float64), ('x', np.float32), ('t', np.float32, (M,))]
    blocks = []
    for ll, factor in GARFIELD_LEVELS:
        b = np.zeros(R, dtype)
        b['ll'] = ll
        b['x'] = tbl['x']
        b['t'] = tbl['t'] * np.float32(factor)
        blocks.append(b)
    np.savez(path, np.concatenate(blocks))
    return str(path)


def write_pattern_map(path, seed: int):
    """Write a smooth, positive S2 pattern map to ``path`` in straxen's
    regular-grid InterpolatingMap JSON layout: x, y in [-50, 50] cm on a
    30 x 30 grid, one value per XENONnT TPC channel (494).

    Each channel sees a Gaussian light spot (sigma 15 cm) around a seeded
    position plus a floor of 0.2 of its peak; the values at each grid
    point are scaled to sum to the default dummy pattern's sum (494 x
    30e-5) times a smooth factor between 0.95 and 1.05, and stored as
    float32.  Values span a factor of ~6, so float64 sums of them are
    exact."""
    import json
    n_channels, n_grid, half_width = 494, 30, 50.0
    total = n_channels * 30e-5
    rng = np.random.default_rng(seed)
    ax = np.linspace(-half_width, half_width, n_grid)
    gx, gy = np.meshgrid(ax, ax, indexing='ij')
    centre = rng.uniform(-half_width, half_width, (n_channels, 2))
    d2 = ((gx[..., None] - centre[:, 0]) ** 2
          + (gy[..., None] - centre[:, 1]) ** 2)
    vals = 0.2 + np.exp(-d2 / (2 * 15.0 ** 2))
    vals *= total / vals.sum(axis=-1, keepdims=True)
    vals *= (1 + 0.05 * np.sin(gx / 20.0) * np.cos(gy / 20.0))[..., None]
    vals = vals.astype(np.float32)
    payload = {
        'coordinate_system': [['x', [-half_width, half_width, n_grid]],
                              ['y', [-half_width, half_width, n_grid]]],
        'map': vals.tolist(),
        'name': 'synthetic S2 pattern map',
        'description': f'write_pattern_map(seed={seed})',
    }
    with open(path, 'w') as f:
        json.dump(payload, f)
    return str(path)


#: file names of :func:`write_production_files`, by config key
PRODUCTION_FILES = dict(noise_file='noise_801.npz',
                        photon_ap_cdfs='pmt_ap_cdfs.json',
                        photon_area_distribution='spe.csv')


def write_production_files(aux_dir, seed: int, *, noise_length: int = 100_000):
    """Write the three resource files a production XENONnT configuration
    names into ``aux_dir`` (see ``config.he_full_grid_overrides``), each
    holding the synthetic asset the simulator would otherwise draw:

    - ``noise_801.npz``: ``synthetic_noise(801, noise_length, seed=seed)``
      as int16 under ``arr_0``, shaped (L, 801):
      a noise trace for every digitizer channel, the HE copies and the sum
      channel included;
    - ``pmt_ap_cdfs.json``: ``synthetic_pmt_ap_cdfs(494)``, each
      element's delay-time CDF stored as its single row (every channel's
      row is the same; the loaders tile a 1-d CDF over the channels);
    - ``spe.csv``: ``synthetic_spe_distribution(494)`` in the
      reference's layout, a ``charge`` column and one pdf column per
      channel, values written with ``repr`` (exact round trip).

    Returns {config key: path}."""
    import csv
    import json
    from pathlib import Path
    n_pmts, n_digitizer_channels = 494, 801      # XENONnT
    aux = Path(aux_dir)
    aux.mkdir(parents=True, exist_ok=True)
    paths = {k: str(aux / name) for k, name in PRODUCTION_FILES.items()}

    noise = synthetic_noise(n_digitizer_channels, noise_length, seed=seed)
    if noise.min() < -2 ** 15 or noise.max() >= 2 ** 15:
        raise ValueError('synthetic noise does not fit int16')
    np.savez(paths['noise_file'], noise.astype(np.int16))

    ap = {}
    for name, el in synthetic_pmt_ap_cdfs(n_pmts).items():
        ap[name] = dict(delaytime_cdf=el['delaytime_cdf'][0].tolist(),
                        amplitude_cdf=el['amplitude_cdf'].tolist(),
                        delaytime_bin_size=el['delaytime_bin_size'],
                        amplitude_bin_size=el['amplitude_bin_size'])
    with open(paths['photon_ap_cdfs'], 'w') as f:
        json.dump(ap, f)

    charge, pdfs = synthetic_spe_distribution(n_pmts)
    with open(paths['photon_area_distribution'], 'w', newline='') as f:
        out = csv.writer(f)
        out.writerow(['charge'] + [str(c) for c in range(n_pmts)])
        for i, q in enumerate(charge):
            out.writerow([repr(float(q))] + [repr(float(v))
                                             for v in pdfs[:, i]])
    return paths


#: file names of :func:`write_field_maps`, by config key
FIELD_MAP_FILES = dict(s1_time_spline='s1_time_spline.json',
                       s2_time_spline='s2_time_spline.json',
                       field_distortion_comsol_map='fd_comsol.json',
                       gas_gap_map='gas_gap.json',
                       field_dependencies_map='field_dependencies.json',
                       diffusion_longitudinal_map='diffusion_longitudinal.json',
                       se_gain_map='se_gain.json')


def _write_regular_map(path, axes, maps, name):
    """One straxen regular-grid InterpolatingMap JSON file: ``axes`` a list
    of (name, (low, high, n)), ``maps`` {map name: float32 values shaped
    by the axes}."""
    import json
    payload = {'coordinate_system': [[a, [float(lo), float(hi), int(n)]]
                                     for a, (lo, hi, n) in axes]}
    for k, v in maps.items():
        payload[k] = np.asarray(v, dtype=np.float32).tolist()
    payload.update(name=name, description=f'synthetic {name}')
    with open(path, 'w') as f:
        json.dump(payload, f)


def write_field_maps(aux_dir, seed: int):
    """Write the map files of the ``field_maps`` configuration (see
    ``config.field_maps_overrides``) into ``aux_dir``, each in straxen's
    regular-grid JSON layout, with smooth values that vary across the
    grid (so every lookup interpolates) and seeded coefficients.  The
    shapes and magnitudes are illustrative, not a calibration:

    - ``s1_time_spline.json``: maps ``top`` and ``bottom`` over (z, u),
      z in [-100, 0] cm, u in [0, 1]: an S1 photon's optical propagation
      delay at quantile u, increasing in u, ~1-40 ns, longer to the top
      array from deep interactions and to the bottom from shallow ones;
    - ``s2_time_spline.json``: ``top`` and ``bottom`` over (u): the S2
      photon's delay, ~0-25 ns, increasing in u;
    - ``fd_comsol.json``: ``map`` over (r, z), r in [0, 70] cm: the
      observed radius, pulled inward by up to ~7 % at the wall and depth;
    - ``gas_gap.json``: ``map`` over (x, y) in [-70, 70] cm: the gas gap,
      0.23-0.29 cm, sagging towards the centre;
    - ``field_dependencies.json``: over (r, z), ``drift_speed_map``
      (1.3-1.7, in units of 10^-4 cm/ns), ``survival_probability_map``
      (0.85-1.0), ``diffusion_radial_map`` and ``diffusion_azimuthal_map``
      (~40-60, in units of 10^-9 cm^2/ns);
    - ``diffusion_longitudinal.json``: ``map`` over (r, z), 2.5e-8 to
      3.5e-8 cm^2/ns;
    - ``se_gain.json``: ``map`` over (x, y), 28-34 photons an electron.

    Returns {config key: path} (:data:`FIELD_MAP_FILES`)."""
    from pathlib import Path
    aux = Path(aux_dir)
    aux.mkdir(parents=True, exist_ok=True)
    paths = {k: str(aux / name) for k, name in FIELD_MAP_FILES.items()}
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.9, 1.1, 12)

    def grid(*specs):
        return np.meshgrid(*(np.linspace(lo, hi, n) for lo, hi, n in specs),
                           indexing='ij')

    zu = ((-100.0, 0.0, 21), (0.0, 1.0, 51))
    z, u = grid(*zu)
    depth = -z / 100.0
    _write_regular_map(paths['s1_time_spline'], list(zip('zu', zu)), {
        'top': 1.0 + c[0] * 20.0 * u ** 1.5 * (1 + 0.6 * depth),
        'bottom': 0.5 + c[1] * 14.0 * u ** 1.5 * (1.6 - 0.6 * depth)},
        'S1 optical propagation spline')
    u1 = (0.0, 1.0, 101)
    (u,) = grid(u1)
    _write_regular_map(paths['s2_time_spline'], [('u', u1)], {
        'top': c[2] * 2.0 * -np.log1p(-0.999 * u),
        'bottom': c[3] * (3.0 + 18.0 * u ** 2)},
        'S2 optical propagation spline')

    rz = ((0.0, 70.0, 36), (-100.0, 0.0, 21))
    r, z = grid(*rz)
    depth = -z / 100.0
    frac = r / 70.0
    _write_regular_map(paths['field_distortion_comsol_map'],
                       list(zip('rz', rz)),
                       {'map': r * (1 - c[4] * 0.07 * frac * (0.3 + depth))},
                       'COMSOL field distortion')
    _write_regular_map(paths['field_dependencies_map'], list(zip('rz', rz)), {
        'drift_speed_map': 1.5 + c[5] * 0.2 * (0.5 - depth) * (1 - 0.5 * frac)
        - 0.1 * frac ** 2,
        'survival_probability_map': 1.0 - c[6] * 0.15 * depth * (0.5 + 0.5 * frac),
        'diffusion_radial_map': c[7] * (45.0 + 10.0 * depth + 5.0 * frac),
        'diffusion_azimuthal_map': c[8] * (48.0 + 6.0 * depth - 4.0 * frac)},
        'field dependencies')
    _write_regular_map(paths['diffusion_longitudinal_map'],
                       list(zip('rz', rz)),
                       {'map': c[9] * (2.7e-8 + 0.5e-8 * depth
                                       + 0.2e-8 * frac)},
                       'longitudinal diffusion')

    xy = ((-70.0, 70.0, 29), (-70.0, 70.0, 29))
    x, y = grid(*xy)
    r2 = (x ** 2 + y ** 2) / 70.0 ** 2
    _write_regular_map(paths['gas_gap_map'], list(zip('xy', xy)), {
        'map': 0.23 + c[10] * 0.05 * np.minimum(r2, 1.0)
        + 0.005 * np.sin(x / 15.0) * np.cos(y / 20.0)}, 'gas gap')
    _write_regular_map(paths['se_gain_map'], list(zip('xy', xy)), {
        'map': c[11] * (31.0 - 3.0 * np.minimum(r2, 1.0)
                        + 1.0 * np.sin(x / 25.0 + y / 30.0))}, 'SE gain')
    return paths


class _G4Branch:
    def __init__(self, values):
        self._values = values

    def array(self, library='np'):
        if library != 'np':
            raise NotImplementedError('only library="np" is supported')
        return self._values


class _G4Tree:
    def __init__(self, branches):
        self._branches = branches

    def keys(self):
        return list(self._branches)

    def __getitem__(self, name):
        return _G4Branch(self._branches[name])


class SyntheticG4File:
    """An in-memory stand-in for a GEANT4 optical-MC ROOT file: the slice
    of the ``uproot`` / ``resources.rootio`` file API that
    ``interface.instructions.read_optical`` reads (``get('events')``, then
    ``events[branch].array(library='np')``).  A module whose ``open``
    returns it can take ``uproot``'s place in ``sys.modules``."""

    def __init__(self, branches):
        self.events = _G4Tree(branches)

    def get(self, name):
        if name != 'events':
            raise AttributeError(f'no TTree named {name!r} in file')
        return self.events

    __getitem__ = get


def synthetic_g4_file(n_events: int, seed: int, *, first_channel: int,
                      n_channels: int, mean_hits: float, tau_ns: float,
                      tail_every: int = 50, tail_fraction: float = 0.05,
                      tail_ns=(2_000.0, 20_000.0)) -> SyntheticG4File:
    """The GEANT4 ``events`` tree of ``n_events`` events (illustrative
    inputs, not a calibration): per event a Poisson number of hits (mean
    ``mean_hits``) on ``pmthitID`` uniform in ``first_channel`` ..
    ``first_channel + n_channels - 1``, ``pmthitTime`` in seconds from an
    exponential of ``tau_ns`` cut below 1 us, except that every
    ``tail_every``-th event moves ``tail_fraction`` of its hits uniformly
    into ``tail_ns`` (so ``utils.optical_adjustment`` splits it),
    ``pmthitEnergy`` uniform in 2.0-4.1 eV (302-620 nm) and the primary
    position ``xp_pri`` / ``yp_pri`` / ``zp_pri`` in mm, uniform in a
    cylinder of radius 600 mm and depth 1,400 mm.  The dtypes are those
    of the GEANT4 files (int32 ids, float64 times, float32 energies and
    positions)."""
    rng = np.random.default_rng(seed)
    n_hits = rng.poisson(mean_hits, n_events)
    ids = np.empty(n_events, object)
    times = np.empty(n_events, object)
    energies = np.empty(n_events, object)
    cut = 1.0 - np.exp(-1_000.0 / tau_ns)
    for i, n in enumerate(n_hits):
        ids[i] = rng.integers(first_channel, first_channel + n_channels,
                              n).astype(np.int32)
        t = -tau_ns * np.log1p(-cut * rng.random(n))
        if tail_every and i % tail_every == tail_every - 1:
            late = rng.random(n) < tail_fraction
            t[late] = rng.uniform(*tail_ns, int(late.sum()))
        times[i] = t * 1e-9
        energies[i] = rng.uniform(2.0, 4.1, n).astype(np.float32)
    r = 600.0 * np.sqrt(rng.random(n_events))
    phi = rng.uniform(-np.pi, np.pi, n_events)
    return SyntheticG4File(dict(
        eventid=np.arange(n_events, dtype=np.int32),
        pmthitID=ids, pmthitTime=times, pmthitEnergy=energies,
        xp_pri=(r * np.cos(phi)).astype(np.float32),
        yp_pri=(r * np.sin(phi)).astype(np.float32),
        zp_pri=rng.uniform(-1_400.0, 0.0, n_events).astype(np.float32)))


def synthetic_nv_pmt_qe(channels, qe_percent: float = 30.0,
                        wavelengths=(300.0, 600.0)) -> dict:
    """An in-memory ``nv_pmt_qe`` entry (the layout of the nVeto QE
    resource file): a flat ``qe_percent`` between the two wavelengths (nm)
    on each of ``channels``, 0 outside (illustrative, not a
    calibration)."""
    lo, hi = wavelengths
    return dict(nv_pmt_qe_wavelength=[lo - 1.0, lo, hi, hi + 1.0],
                nv_pmt_qe={str(int(c)): [0.0, qe_percent, qe_percent, 0.0]
                           for c in channels})
