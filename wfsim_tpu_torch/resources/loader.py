"""Resource resolution for the port: config -> in-memory detector assets.

Counterpart of ``wfsim_tpu/resources/loader.py`` for the paths the port
runs: ``['constant dummy', value, shape]`` map entries and map files
(straxen InterpolatingMap JSON, regular-grid or scattered, compressed
pattern maps; npy/npz/pkl payloads), the derived S1 LCE and S2
correction maps and the S2 area-fraction-top rescale, the SPE table (a
measured spectrum csv or the synthetic one), the ``garfield_gas_gap``
luminescence tables, the inverse-FDC and COMSOL field-distortion maps,
the gas-gap map of gas-gap warping, the field-dependency maps (drift
speed, survival probability, radial and azimuthal diffusion; a constant
dummy becomes four constant maps) with the ``norm_drift_velocity``
scaling, the longitudinal-diffusion map, the S1 and S2 optical
propagation splines, the nVeto PMT quantum efficiencies and, when
enabled, the PMT-afterpulse CDFs, the electron-afterpulse delay PMF and the
noise bank (a resource file, an in-memory entry or the synthetic
asset) and the ``garfield`` wire-distance luminescence table (an in-memory
``{'t', 'x'}`` table or a file, of whose liquid levels ``ll`` the
nearest one is taken) (wfsim_tpu/resources/loader.py:141-575).  Every
map is a :class:`~wfsim_tpu_torch.ops.interp.GridMap` of host float32
tensors; the device copy is made by ``models.params.build_params``.

Files resolve as in wfsim_tpu: an absolute path, else a local search
directory (``url_base`` when it is a directory, ``$WFSIM_TPU_AUX_DIR``),
else, only where ``WFSIM_TPU_ALLOW_DOWNLOAD=1``, the remote fetch
(straxen's ``MongoDownloader`` where straxen is installed, then an http
``url_base``, then the public GitHub raw bases) into a persistent cache
(``$WFSIM_TPU_DOWNLOAD_CACHE``, by default ``~/.cache/wfsim_tpu_aux``).
A ``noise_file``, ``photon_ap_cdfs``, ``photon_area_distribution`` or
``ele_ap_pdfs`` name that resolves nowhere takes the synthetic asset, and
an ``nv_pmt_qe`` name none (QE 100 %), as in wfsim_tpu; a map file or a
``garfield`` table found nowhere raises ``FileNotFoundError``, as there.
An ``ele_ap_pdfs`` file is read by extension (a pickle holds the
reference's histogram object) and used through its ``n``,
``bin_centers`` and ``get_random``, as the synthetic PMF is.
"""
from __future__ import annotations

import functools
import gzip
import json
import logging
import os
import os.path as osp
import pickle

import numpy as np
import torch

from ..ops.interp import GridMap, grid_lookup_ref, regrid_scattered
from .spe import build_uniform_to_pe, spe_table_from_csv
from . import synthetic as synth

__all__ = ['Resource', 'load_config', 'make_map', 'make_patternmap',
           'DummyMap', 'MultiMap', 'get_file_path',
           'interpolating_map_to_grid', 'garfield_table']

log = logging.getLogger('wfsim_tpu_torch.resource')


def load_config(config) -> 'Resource':
    """Resource factory (same name as wfsim_tpu.resources.load_config).
    Not cached: a dummy-map resource takes milliseconds, and a file map is
    read once per simulator."""
    return Resource(config)


# ---------------------------------------------------------------------------
# File access


def _search_dirs(config):
    dirs = []
    base = config.get('url_base', '')
    if isinstance(base, str) and base.startswith('/'):
        dirs.append(base)
    env = os.environ.get('WFSIM_TPU_AUX_DIR')
    if env:
        dirs.append(env)
    return dirs


#: GitHub raw bases the reference falls back to for named public aux files
#: (reference load_resource.py:178-196; wfsim_tpu loader.py:89-95)
_GITHUB_RAW_BASES = (
    'https://raw.githubusercontent.com/XENONnT/private_nt_aux_files/master/sim_files/',  # noqa: E501
    'https://raw.githubusercontent.com/XENONnT/WFSim/master/files/',
    'https://raw.githubusercontent.com/XENON1T/WFSim/master/files/',
)


def _download_cache_dir():
    """The persistent cache of fetched files (wfsim_tpu loader.py:98)."""
    d = os.environ.get('WFSIM_TPU_DOWNLOAD_CACHE') or osp.join(
        osp.expanduser('~'), '.cache', 'wfsim_tpu_aux')
    os.makedirs(d, exist_ok=True)
    return d


def _fetch_remote(config, fname):
    """The remote fetch of a named file (wfsim_tpu loader.py:105-138;
    reference load_resource.py:131-196), off unless
    ``WFSIM_TPU_ALLOW_DOWNLOAD=1``: the cached copy, else straxen's
    ``MongoDownloader`` (where straxen is installed), else each base in
    turn, an http ``url_base`` first, into the cache.  Returns the local
    path or None."""
    if os.environ.get('WFSIM_TPU_ALLOW_DOWNLOAD') != '1':
        return None
    cache = _download_cache_dir()
    cached = osp.join(cache, fname)
    if osp.exists(cached):
        return cached
    try:
        from straxen import MongoDownloader
    except ImportError:
        MongoDownloader = None
    if MongoDownloader is not None:
        try:
            path = MongoDownloader().download_single(fname)
        except Exception as exc:     # no database access: try the bases
            log.info('straxen MongoDownloader: %s: %s', fname, exc)
        else:
            if path and osp.exists(path):
                return path
    bases = []
    ub = config.get('url_base', '')
    if isinstance(ub, str) and ub.startswith('http'):
        bases.append(ub if ub.endswith('/') else ub + '/')
    bases += list(_GITHUB_RAW_BASES)
    import urllib.request
    tmp = cached + '.part'
    for base in bases:
        try:
            urllib.request.urlretrieve(base + fname, tmp)
        except (OSError, ValueError) as exc:
            log.info('fetch of %s from %s failed: %s', fname, base, exc)
            continue
        os.replace(tmp, cached)
        log.info('downloaded %s from %s', fname, base)
        return cached
    return None


def get_file_path(config, fname):
    """Resolve a resource file name to a local path, or None: an absolute
    path, else the local ``url_base`` directory, else $WFSIM_TPU_AUX_DIR,
    else the opt-in remote fetch (:func:`_fetch_remote`; wfsim_tpu
    loader.py:141-156)."""
    if not fname or not isinstance(fname, str):
        return None
    if fname.startswith('/'):
        return fname if osp.exists(fname) else None
    for d in _search_dirs(config):
        p = osp.join(d, fname)
        if osp.exists(p):
            return p
    return _fetch_remote(config, fname)


def _read_any(path):
    """Load a resource file by extension (wfsim_tpu loader.py:159)."""
    if path.endswith('.json'):
        with open(path) as f:
            return json.load(f)
    if path.endswith('.json.gz'):
        with gzip.open(path, 'rt') as f:
            return json.load(f)
    if path.endswith('.npy'):
        return np.load(path, allow_pickle=True)
    if path.endswith('.npz'):
        d = np.load(path, allow_pickle=True)
        return d['arr_0'] if 'arr_0' in d else d
    if path.endswith('.pkl'):
        with open(path, 'rb') as f:
            return pickle.load(f)
    if path.endswith(('.pkl.gz', '.pklz')):
        with gzip.open(path, 'rb') as f:
            return pickle.load(f)
    raise ValueError(f'Unknown resource format: {path}')


# ---------------------------------------------------------------------------
# Map construction


class DummyMap:
    """Constant map entry (the reference's DummyMap,
    wfsim/load_resource.py:437-457); ``as_gridmap`` makes its device form."""

    def __init__(self, const, shape=()):
        self.const = const
        self.shape = tuple(shape)

    def reduce_last_dim(self):
        if len(self.shape) < 1:
            raise ValueError('Need at least 1 dim to reduce further')
        const = self.const * self.shape[-1]
        shape = list(self.shape)
        shape[-1] = 1
        return DummyMap(const, shape)


class MultiMap:
    """Named-submap container (straxen InterpolatingMap files may hold
    several maps); ``default`` names the one the simulator reads."""

    def __init__(self, maps: dict, default: str = 'map'):
        self.maps = maps
        self.default = default


def _axes_are_regular_spec(cs):
    # straxen regular-grid spec: [['x', [min, max, n]], ...]
    return (len(cs) > 0 and isinstance(cs[0], (list, tuple)) and len(cs[0]) == 2
            and isinstance(cs[0][0], str))


def interpolating_map_to_grid(map_data: dict, n_grid: int = 50) -> MultiMap:
    """Convert a straxen InterpolatingMap payload into GridMaps: the
    regular-grid layout directly (non-uniform axes resampled), the
    scattered-point layout re-gridded (wfsim_tpu loader.py:235)."""
    cs = map_data['coordinate_system']
    ignore = {'coordinate_system', 'name', 'description', 'timestamp',
              'compressed', 'quantized', 'irregular', 'deviation_matrix'}
    map_names = [k for k in map_data if k not in ignore]
    out = {}
    if _axes_are_regular_spec(cs):
        axes = []
        for _, spec in cs:
            if len(spec) == 3:
                axes.append(np.linspace(spec[0], spec[1], int(spec[2])))
            else:
                axes.append(np.asarray(spec, dtype=np.float64))
        for name in map_names:
            vals = np.asarray(map_data[name], dtype=np.float32)
            vals, axes_u = _uniformize(vals, axes)
            out[name] = GridMap.from_axes(vals, axes_u)
    else:
        pts = np.asarray(cs, dtype=np.float64)
        if pts.ndim == 1:
            pts = pts[:, None]
        for name in map_names:
            vals = np.asarray(map_data[name], dtype=np.float64)
            out[name] = regrid_scattered(pts, vals, n_grid=n_grid)
    default = 'map' if 'map' in out else map_names[0]
    return MultiMap(out, default=default)


def _uniformize(vals, axes):
    """Resample map values on possibly non-uniform axes onto uniform axes
    (the lookup assumes uniform spacing; wfsim_tpu loader.py:269)."""
    new_axes = []
    need = False
    for a in axes:
        d = np.diff(a)
        if len(d) and not np.allclose(d, d[0], rtol=1e-3):
            need = True
        new_axes.append(np.linspace(a[0], a[-1], len(a)))
    if not need:
        return vals, axes
    from scipy.interpolate import RegularGridInterpolator
    extra = vals.shape[len(axes):]
    rgi = RegularGridInterpolator(tuple(axes), vals, bounds_error=False,
                                  fill_value=None)
    mesh = np.meshgrid(*new_axes, indexing='ij')
    q = np.stack([mm.ravel() for mm in mesh], axis=1)
    newvals = rgi(q).reshape(*[len(a) for a in new_axes], *extra)
    return newvals.astype(np.float32), new_axes


def _decompress_pattern(map_data: dict) -> dict:
    """Undo a pattern map's compression and quantization (wfsim_tpu
    loader.py:291)."""
    map_data = dict(map_data)
    if 'compressed' in map_data:
        compressor, dtype, shape = map_data['compressed']
        raw = map_data['map']
        if compressor in ('zstd', 'blosc'):
            try:
                if compressor == 'zstd':
                    import zstandard
                    raw = zstandard.ZstdDecompressor().decompress(raw)
                else:
                    import blosc
                    raw = blosc.decompress(raw)
            except ImportError as e:
                raise RuntimeError(
                    f'Pattern map uses {compressor} compression but the codec '
                    f'is not installed') from e
        map_data['map'] = np.frombuffer(raw, dtype=dtype).reshape(*shape)
        del map_data['compressed']
    if 'quantized' in map_data:
        map_data['map'] = map_data['quantized'] * map_data['map'].astype(np.float32)
        del map_data['quantized']
    return map_data


def make_map(entry, config=None, n_grid: int = 50):
    """Resolve one config map entry: dummy list, file name or None."""
    config = config or {}
    if entry is None or entry is False or entry == '':
        return None
    if isinstance(entry, list) and entry and entry[0] == 'constant dummy':
        return DummyMap(entry[1], entry[2] if len(entry) > 2 else ())
    if isinstance(entry, str):
        path = get_file_path(config, entry)
        if path is None:
            raise FileNotFoundError(
                f'Resource file {entry!r} not found locally. Set url_base to a '
                f'local directory or $WFSIM_TPU_AUX_DIR, or use a '
                f'["constant dummy", value, shape] entry.')
        data = _read_any(path)
        if isinstance(data, dict) and 'coordinate_system' in data:
            return interpolating_map_to_grid(_decompress_pattern(data), n_grid)
        raise ValueError(f'Unsupported map payload in {path}')
    raise TypeError(f"Can't handle map entry {entry!r}")


def make_patternmap(entry, config=None, pmt_mask=None, n_grid: int = 30):
    """Pattern-map variant: decompressed and dequantized, masked PMTs
    zeroed (reference: wfsim/load_resource.py:403-435)."""
    m = make_map(entry, config, n_grid=n_grid)
    if isinstance(m, MultiMap) and pmt_mask is not None:
        dead = torch.from_numpy(~np.asarray(pmt_mask))
        for g in m.maps.values():
            if g.values.shape[-1] == len(pmt_mask):
                g.values[..., dead] = 0.0
    return m


def as_gridmap(m, ndim_in=2):
    """DummyMap / MultiMap / GridMap / None -> GridMap / None (wfsim_tpu
    loader ``_as_gridmap``)."""
    if m is None:
        return None
    if isinstance(m, DummyMap):
        want = int(np.prod(m.shape)) if m.shape else 1
        return GridMap.constant(m.const, out_dim=max(want, 1),
                                ndim_in=ndim_in)
    if isinstance(m, MultiMap):
        return m.maps[m.default]
    return m


class Resource:
    """All in-memory assets for one configuration (wfsim_tpu
    resources.loader.Resource for the ported paths)."""

    def __init__(self, config):
        n_pmts = int(config['n_tpc_pmts'])
        n_top = int(config['n_top_pmts'])
        pmt_mask = np.asarray(config['gains'], dtype=np.float64) > 0

        self.s1_pattern_map = make_patternmap(config.get('s1_pattern_map'),
                                              config, pmt_mask)
        self.s2_pattern_map = make_patternmap(config.get('s2_pattern_map'),
                                              config, pmt_mask)
        self.se_gain_map = make_map(config.get('se_gain_map'), config)

        # S1 LCE: a data-driven map, else the sum of the pattern map over
        # live PMTs (reference: load_resource.py:243-250)
        lce = config.get('s1_lce_correction_map')
        if lce:
            self.s1_lce_correction_map = make_map(lce, config)
        elif isinstance(self.s1_pattern_map, DummyMap):
            self.s1_lce_correction_map = self.s1_pattern_map.reduce_last_dim()
        else:
            self.s1_lce_correction_map = _pattern_sum(
                as_gridmap(self.s1_pattern_map), pmt_mask)

        # S2 AFT rescale (reference: load_resource.py:252-267); a dummy
        # pattern map is left as it is, as wfsim_tpu does
        aft = config.get('s2_mean_area_fraction_top', -1)
        if aft is not None and aft >= 0 \
                and not isinstance(self.s2_pattern_map, DummyMap):
            g = as_gridmap(self.s2_pattern_map)
            vals = g.values.numpy().copy()
            top_eff = vals[..., :n_top].sum(axis=-1)
            tot_eff = vals.sum(axis=-1)
            orig = np.mean((top_eff / tot_eff)[tot_eff > 0])
            vals[..., :n_top] *= aft / orig
            vals[..., n_top:n_pmts] *= (1 - aft) / (1 - orig)
            g.values = torch.from_numpy(vals)

        # S2 correction: a data-driven map, else the pattern sum over its
        # median (reference: load_resource.py:269-280)
        s2c = config.get('s2_correction_map')
        if s2c:
            self.s2_correction_map = make_map(s2c, config)
        elif isinstance(self.s2_pattern_map, DummyMap):
            self.s2_correction_map = self.s2_pattern_map.reduce_last_dim()
        else:
            g = _pattern_sum(as_gridmap(self.s2_pattern_map), pmt_mask)
            summed = g.values.numpy()
            g.values = torch.from_numpy(summed / np.median(summed[summed > 0]))
            self.s2_correction_map = g

        # garfield gas-gap luminescence tables (wfsim_tpu loader.py:430-444)
        self.s2_luminescence_gg = None
        self.garfield_gas_gap_map = None
        if 'garfield_gas_gap' in str(config.get('s2_luminescence_model')):
            entry = config.get('s2_luminescence_gg')
            if isinstance(entry, str):
                path = get_file_path(config, entry)
                self.s2_luminescence_gg = (_read_any(path) if path else
                                           synth.synthetic_garfield_gas_gap())
            elif isinstance(entry, dict):
                self.s2_luminescence_gg = entry
            else:
                self.s2_luminescence_gg = synth.synthetic_garfield_gas_gap()
            ggm = config.get(
                'garfield_gas_gap_map',
                ['constant dummy',
                 float(np.mean(self.s2_luminescence_gg['gas_gap'])), []])
            self.garfield_gas_gap_map = make_map(ggm, config)

        # garfield wire-distance luminescence table (wfsim_tpu
        # loader.py:445-462)
        self.s2_luminescence = None
        if str(config.get('s2_luminescence_model')) == 'garfield':
            self.s2_luminescence = garfield_table(config)

        # inverse FDC (wfsim_tpu loader.py:465-479): the map is stored
        # against drift time, so its z axis is scaled by -drift_velocity
        # (reference load_resource.py:311-313)
        self.fdc_3d = None
        if config.get('field_distortion_model') == 'inverse_fdc':
            self.fdc_3d = as_gridmap(make_map(config.get('fdc_3d'), config),
                                     ndim_in=3)
            if self.fdc_3d is not None:
                v = config['drift_velocity_liquid']
                scale = torch.tensor([1.0, 1.0, -v], dtype=torch.float32)
                lo = self.fdc_3d.lows * scale
                hi = self.fdc_3d.highs * scale
                self.fdc_3d.lows = torch.minimum(lo, hi)
                self.fdc_3d.highs = torch.maximum(lo, hi)

        # COMSOL field distortion (wfsim_tpu loader.py:480-482): the
        # observed radius over (r, z)
        self.fd_comsol = None
        if config.get('field_distortion_model') == 'comsol':
            self.fd_comsol = make_map(config.get('field_distortion_comsol_map'),
                                      config)

        # gas-gap warping (wfsim_tpu loader.py:484-487): the gas gap over
        # (x, y), by default the constant elr_gas_gap_length
        self.gas_gap_length = None
        if config.get('enable_gas_gap_warping', False):
            self.gas_gap_length = make_map(config.get(
                'gas_gap_map', ['constant dummy',
                                config.get('elr_gas_gap_length', 0.25), []]),
                config)

        self._field_dependencies(config)

        # optical propagation splines (wfsim_tpu loader.py:538-543)
        for k in ('s1', 's2'):
            entry = config.get(k + '_time_spline', False)
            setattr(self, k + '_optical_propagation_spline',
                    make_map(entry, config) if entry else None)

        # nVeto PMT quantum efficiencies (wfsim_tpu loader.py:545-550): a
        # resource file or an in-memory dict, read by
        # ``interface.instructions.read_optical``; a name found nowhere
        # gives none (every QE 100 %)
        self.nv_pmt_qe = None
        if config.get('detector') == 'XENONnT_neutron_veto':
            entry = config.get('nv_pmt_qe')
            path = _file_of(config, 'nv_pmt_qe', 'no QE table (QE 100 %)')
            if path:
                self.nv_pmt_qe = _read_any(path)
            elif isinstance(entry, dict):
                self.nv_pmt_qe = entry

        # SPE gain table (wfsim_tpu loader.py:552-562): a measured
        # spectrum csv, else the synthetic spectrum
        path = _file_of(config, 'photon_area_distribution',
                        'synthetic_spe_distribution')
        if path:
            self.uniform_to_pe = spe_table_from_csv(path, n_pmts)
        else:
            charge, pdfs = synth.synthetic_spe_distribution(n_pmts)
            self.uniform_to_pe = build_uniform_to_pe(charge, pdfs)

        # afterpulse tables and noise bank (wfsim_tpu loader.py:511-535,
        # 564-573): a resource file, an in-memory entry or the synthetic
        # asset
        self.uniform_to_pmt_ap = None
        if config.get('enable_pmt_afterpulses', False):
            entry = config.get('photon_ap_cdfs')
            path = _file_of(config, 'photon_ap_cdfs', 'synthetic_pmt_ap_cdfs')
            if path:
                self.uniform_to_pmt_ap = _read_pmt_ap(path)
            elif isinstance(entry, dict):
                self.uniform_to_pmt_ap = entry
            else:
                self.uniform_to_pmt_ap = synth.synthetic_pmt_ap_cdfs(n_pmts)
        self.uniform_to_ele_ap = None
        if config.get('enable_electron_afterpulses', False):
            entry = config.get('ele_ap_pdfs')
            path = _file_of(config, 'ele_ap_pdfs', 'synthetic_ele_ap_pmf')
            if path:
                self.uniform_to_ele_ap = _read_any(path)
            elif entry is not None and not isinstance(entry, str):
                self.uniform_to_ele_ap = entry
            else:
                self.uniform_to_ele_ap = synth.synthetic_ele_ap_pmf()
        self.noise_bank = None
        if config.get('enable_noise', False):
            path = _file_of(config, 'noise_file', 'synthetic_noise')
            if path:
                self.noise_bank = noise_bank_from_file(
                    path, int(config.get('n_digitizer_channels', n_pmts)))
            else:
                self.noise_bank = synthetic_noise_bank(n_pmts)

    def _field_dependencies(self, config):
        """The field-dependency maps (wfsim_tpu loader.py:489-509): read
        where a key other than ``norm_drift_velocity`` is on, a constant
        dummy becoming the four named constant (r, z) maps; then the
        ``norm_drift_velocity`` scaling, the configured drift velocity over
        the map's at (r, z) = (0, -tpc_length) (1.0 without it; where only
        ``norm_drift_velocity`` is on, nothing is read and the drift stays
        constant, as in wfsim_tpu); and the longitudinal-diffusion map."""
        efd = config.get('enable_field_dependencies', {})
        self.field_dependencies_map = self.drift_velocity_scaling = None
        self.diffusion_longitudinal_map = None
        if not isinstance(efd, dict):
            return
        if any(bool(v) for k, v in efd.items() if k != 'norm_drift_velocity'):
            m = make_map(config.get('field_dependencies_map'), config)
            if isinstance(m, DummyMap):
                m = MultiMap({n: GridMap.constant(m.const, 1, 2)
                              for n in FIELD_MAP_NAMES},
                             default='survival_probability_map')
            self.field_dependencies_map = m
            self.drift_velocity_scaling = 1.0
            if efd.get('norm_drift_velocity', False):
                g = m.maps['drift_speed_map']
                norm = float(grid_lookup_ref(
                    g.values, g.lows, g.highs,
                    torch.tensor([[0.0, -config['tpc_length']]]))[0]) * 1e-4
                self.drift_velocity_scaling = (
                    config['drift_velocity_liquid'] / norm)
        if efd.get('diffusion_longitudinal_map', False):
            self.diffusion_longitudinal_map = make_map(
                config.get('diffusion_longitudinal_map'), config)


#: the maps of a ``field_dependencies_map`` file (wfsim_tpu
#: loader.py:494-499)
FIELD_MAP_NAMES = ('drift_speed_map', 'survival_probability_map',
                   'diffusion_radial_map', 'diffusion_azimuthal_map')


def garfield_table(config):
    """The ``garfield`` table that ``config['s2_luminescence']`` gives: an
    in-memory mapping with ``t`` (R, M) and ``x`` (R,), or the name of a
    file (npz ``arr_0`` / npy structured array with fields ``t``, ``x``
    and optionally ``ll``), of whose liquid levels ``ll`` the one nearest
    ``gate_to_anode_distance - elr_gas_gap_length`` is taken (wfsim_tpu
    loader.py:445-462).  A name found nowhere raises
    ``FileNotFoundError``, as in wfsim_tpu."""
    entry = config.get('s2_luminescence')
    if not isinstance(entry, str):
        if entry is None or 't' not in entry or 'x' not in entry:
            raise ValueError('s2_luminescence_model garfield needs '
                             's2_luminescence: a {t, x} table or a file name')
        return entry
    path = get_file_path(config, entry)
    if path is None:
        raise FileNotFoundError(f'garfield table {entry} not found')
    table = _read_any(path)
    if not isinstance(table, np.ndarray):
        table = table['arr_0']
    if 'll' in (table.dtype.names or ()):
        lls = np.unique(table['ll'])
        ll = config['gate_to_anode_distance'] - config['elr_gas_gap_length']
        ll = lls[np.argmin(np.abs(lls - ll))]
        table = table[table['ll'] == ll]
    return table


def _pattern_sum(g: GridMap, pmt_mask) -> GridMap:
    """The sum of a pattern map over the live PMTs, as a one-output map on
    the same grid (numpy's float32 sum, as wfsim_tpu computes it)."""
    vals = g.values.numpy()[..., np.asarray(pmt_mask)]
    return GridMap(torch.from_numpy(vals.sum(axis=-1, keepdims=True)),
                   g.lows.clone(), g.highs.clone())


def _file_of(config, key, instead):
    """The local path of the file that ``config[key]`` names, or None where
    it names none or the name resolves nowhere; the latter is logged with
    ``instead``, what the caller takes in its place (wfsim_tpu's
    fallback)."""
    entry = config.get(key)
    if not isinstance(entry, str) or not entry:
        return None
    path = get_file_path(config, entry)
    if path is None:
        log.info('%s=%r resolves nowhere; using %s', key, entry, instead)
    return path


def _read_pmt_ap(path):
    """PMT-afterpulse CDFs from a json, json.gz or pkl file: a dict of
    element -> dict of fields, lists turned into arrays (wfsim_tpu
    loader.py:511-522)."""
    data = _read_any(path)
    if not isinstance(data, dict):
        raise ValueError(f'{path}: PMT-afterpulse file holds '
                         f'{type(data).__name__}, expected a dict')
    for element in data.values():
        for k, v in element.items():
            if isinstance(v, list):
                element[k] = np.array(v)
    return data


@functools.lru_cache(maxsize=2)
def _noise_file_bank(path, mtime_ns, size, n_channels_max):
    data = _read_any(path)
    if not isinstance(data, np.ndarray):
        data = data['arr_0']
    bank = np.asarray(data)
    if bank.ndim != 2 or not 0 < bank.shape[1] <= n_channels_max:
        raise ValueError(f'{path}: noise bank of shape {bank.shape}; expected '
                         f'(length, channels) with at most {n_channels_max} '
                         f'channels')
    return _channel_major_int16(bank)


def noise_bank_from_file(path, n_channels_max: int) -> np.ndarray:
    """A noise bank file (npz ``arr_0`` or npy, shaped (L, Cn) with Cn up
    to ``n_channels_max``, wfsim_tpu loader.py:564-573) channel-major,
    (Cn, L) int16, read-only; read once per process while the file is
    unchanged."""
    st = os.stat(path)
    return _noise_file_bank(str(path), st.st_mtime_ns, st.st_size,
                            n_channels_max)


def _channel_major_int16(bank):
    """(L, Cn) integer bank -> (Cn, L) int16, read-only; raises where the
    values do not fit int16."""
    if bank.min() < -2 ** 15 or bank.max() >= 2 ** 15:
        raise ValueError('noise bank values do not fit int16')
    out = np.ascontiguousarray(bank.T.astype(np.int16))
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=2)
def synthetic_noise_bank(n_channels: int) -> np.ndarray:
    """The synthetic noise bank channel-major, (Cn, L) int16, read-only.

    It is the transpose of ``synthetic.synthetic_noise`` (L, Cn): one
    channel's trace is contiguous, which is how the digitizer reads it.
    Drawing it takes seconds at 494 channels, so the array is made once
    per process and shared (hence read-only)."""
    return _channel_major_int16(synth.synthetic_noise(n_channels))
