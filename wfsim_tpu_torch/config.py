"""Configuration system.

Three-tier configuration mirroring the reference's semantics
(reference: wfsim/strax_interface.py:566-608):

1. a (fax-style) JSON config file — parsed leniently (``//`` and ``#``
   comments, trailing commas are tolerated, like the reference's example
   config files);
2. an override dict;
3. values derived at setup time (``gains``, ``channel_map['sum_signal']``,
   ``channels_bottom``, ``turned_off_pmts``, ``current_2_adc``).

The flat config dict is the physics parameter space; key names are kept
identical to the reference so existing fax configs load unchanged.
``default_config()`` provides a fully hermetic parameter set (dummy maps,
analytic SPE pulse shape) usable with no network or data files.
"""
from __future__ import annotations

import json
import hashlib
import os
import re
import typing as ty

import numpy as np

__all__ = [
    'load_fax_config', 'default_config', 'finalize_config',
    'deterministic_hash', 'strip_json_comments', 'CHANNEL_MAPS',
    'detector_physics_overrides', 'he_full_grid_overrides',
    'timing_models_overrides', 'field_maps_overrides', 'PIPELINE_DEFAULTS',
]

#: the super-batch keys of the raw-data stream and wfsim_tpu's defaults for
#: them (wfsim_tpu rawdata.py:1088-1089, read with ``config.get``; like
#: there they are not keys of :func:`default_config`): a run of n
#: instructions is cut into super-batches of about ceil(n /
#: pipeline_depth) instructions, at least pipeline_min_batch
PIPELINE_DEFAULTS = {'pipeline_depth': 3, 'pipeline_min_batch': 64}

# Per-detector channel layout (matches the straxen-provided channel maps the
# reference receives from its context; reference: wfsim/strax_interface.py:524-530)
CHANNEL_MAPS = {
    'XENONnT': {
        'channel_map': {'tpc': (0, 493), 'he': (500, 752), 'aqmon': (790, 807),
                        'nveto': (2000, 2119), 'sum_signal': 800},
        'n_tpc_pmts': 494,
        'n_top_pmts': 253,
        'n_digitizer_channels': 801,
    },
    'XENON1T': {
        'channel_map': {'tpc': (0, 247), 'diagnostic': (248, 253),
                        'aqmon': (254, 260), 'sum_signal': 800},
        'n_tpc_pmts': 248,
        'n_top_pmts': 127,
        'n_digitizer_channels': 801,
    },
    'XENONnT_neutron_veto': {
        'channel_map': {'nveto': (2000, 2119), 'sum_signal': 800},
        'n_tpc_pmts': 120,
        'n_top_pmts': 0,
        'n_digitizer_channels': 801,
    },
}


def strip_json_comments(text: str) -> str:
    """Remove ``//`` / ``#`` line comments (string-aware) and trailing commas."""
    out = []
    for line in text.splitlines():
        res: ty.List[str] = []
        in_str = False
        i = 0
        while i < len(line):
            c = line[i]
            if c == '"' and (i == 0 or line[i - 1] != '\\'):
                in_str = not in_str
                res.append(c)
            elif not in_str and (line[i:i + 2] == '//' or c == '#'):
                break
            else:
                res.append(c)
            i += 1
        out.append(''.join(res))
    text = '\n'.join(out)
    return re.sub(r',(\s*[\]}])', r'\1', text)


def load_fax_config(path_or_name: str, search_dirs: ty.Sequence[str] = ()) -> dict:
    """Load a fax JSON config from an absolute path or a bare file name
    resolved against ``search_dirs`` and ``$WFSIM_TPU_CONFIG_DIR``."""
    candidates = [path_or_name]
    if not os.path.isabs(path_or_name):
        dirs = list(search_dirs)
        env_dir = os.environ.get('WFSIM_TPU_CONFIG_DIR')
        if env_dir:
            dirs.append(env_dir)
        candidates = [os.path.join(d, path_or_name) for d in dirs] + [path_or_name]
    for cand in candidates:
        if os.path.exists(cand):
            with open(cand) as f:
                return json.loads(strip_json_comments(f.read()))
    raise FileNotFoundError(
        f'Cannot resolve fax config {path_or_name!r}; searched {candidates}')


def _analytic_spe_pulse(t_start=-13, t_end=195):
    """Analytic single-PE current pulse shape: difference of exponentials with
    a PMT-like ~3 ns rise and ~25 ns fall, sampled on a 1 ns grid.

    Serves the same role as the tabulated ``pe_pulse_ts``/``pe_pulse_ys`` in
    fax configs (reference config group: PMT pulse shape); this one is
    generated, not measured, and is only used when no config provides one.
    """
    ts = np.arange(t_start, t_end + 1, 1.0)
    tau_r, tau_f = 3.0, 25.0
    t0 = 0.0
    tt = np.clip(ts - t0, 0, None)
    ys = np.exp(-tt / tau_f) - np.exp(-tt / tau_r)
    ys[ts < t0] = 0.0
    ys = np.clip(ys, 0, None)
    ys /= ys.sum()
    return ts.tolist(), ys.tolist()


def default_config(detector: str = 'XENONnT', **overrides) -> dict:
    """A complete, hermetic configuration (dummy maps everywhere).

    Key names match the reference fax-config parameter space
    (see reference files/XENONnT_wfsim_config.json and
    wfsim/strax_interface.py:506-535); values are physically reasonable
    defaults for testing without any external resource files.
    """
    layout = CHANNEL_MAPS[detector]
    pe_ts, pe_ys = _analytic_spe_pulse()
    n_pmts = layout['n_tpc_pmts']
    c = {
        # --- Model selectors ---
        'detector': detector,
        's1_model_type': 'simple',
        's2_time_model': 's2_time_spread around zero',
        's2_luminescence_model': 'simple',
        'field_distortion_model': 'none',
        'enable_gas_gap_warping': False,
        'enable_pmt_afterpulses': False,
        'enable_electron_afterpulses': False,
        'enable_gate_afterpulses': False,
        'enable_noise': False,
        'enable_field_dependencies': {
            'survival_probability_map': False,
            'drift_speed_map': False,
            'diffusion_longitudinal_map': False,
            'diffusion_transverse_map': False,
        },
        # --- Resources (dummy maps: [tag, constant, shape]) ---
        's1_pattern_map': ['constant dummy', 14e-5, [n_pmts]],
        's1_lce_correction_map': None,    # derived from pattern map when None
        's2_pattern_map': ['constant dummy', 30e-5, [n_pmts]],
        's2_correction_map': ['constant dummy', 1, []],
        'se_gain_map': ['constant dummy', 1, []],
        'field_dependencies_map': ['constant dummy', 1, []],
        'photon_area_distribution': None,  # analytic SPE area model when None
        's1_time_spline': False,
        's2_time_spline': False,
        # --- LXe properties ---
        'temperature': 177.45,            # K
        'pressure': 1.210852812592475e+18,  # in internal units (~2 bar)
        'lxe_dielectric_constant': 1.874,
        # --- Geometry ---
        'tpc_length': 97.0,               # cm
        'tpc_radius': 50.0,               # cm
        'anode_wire_radius': 0.01175,     # cm
        'anode_field_domination_distance': 0.036,  # cm
        'elr_gas_gap_length': 0.266,      # cm
        'gate_to_anode_distance': 0.5,    # cm
        # --- Field & transport ---
        'drift_field': 82.0,              # V/cm
        'anode_voltage': 4000.0,          # V
        'diffusion_constant_longitudinal': 2.935e-8,  # cm^2/ns
        'diffusion_constant_transverse': 0.0,         # cm^2/ns
        'drift_time_gate': 1700.0,        # ns
        'drift_velocity_liquid': 0.0001335,  # cm/ns
        # --- Recombination / scintillation ---
        'singlet_fraction_gas': 0.35,
        'singlet_lifetime_gas': 5.88,
        'singlet_lifetime_liquid': 3.1,
        'triplet_lifetime_gas': 149.0,
        'triplet_lifetime_liquid': 24.0,
        's1_ER_alpha_singlet_fraction': 0.7368421052631579,
        's1_ER_primary_singlet_fraction': 0.1452991452991453,
        's1_ER_recombination_fraction': 0.9,
        's1_ER_secondary_singlet_fraction': 0.4444444444444444,
        's1_NR_singlet_fraction': 0.8863636363636364,
        'maximum_recombination_time': 1000.0,
        'led_pulse_length': 100.0,
        # --- S1 model ---
        's1_decay_spread': 5.0,
        's1_decay_time': 44.77,
        's1_detection_efficiency': 0.12,
        # --- S2 model ---
        's2_mean_area_fraction_top': -1,   # negative: no AFT rescale
        's2_secondary_sc_gain': 21.3,
        's2_time_spread': 0.0,
        's2_gain_spread': 0.0,
        's2_aft_sigma': 0.0,
        's2_aft_skewness': 0.0,
        'electron_extraction_yield': 1.0,
        'electron_lifetime_liquid': 650000.0,  # ns
        'electron_trapping_time': 140.0,       # ns
        'gas_drift_velocity_slope': 5.4e12,
        # --- PMT ---
        'p_double_pe_emision': 0.219,
        'pe_pulse_ts': pe_ts,
        'pe_pulse_ys': pe_ys,
        'pmt_pulse_time_rounding': 1.0,
        'pmt_transit_time_mean': 46.0,
        'pmt_transit_time_spread': 9.0,
        'pmt_ap_modifier': 1.0,
        'pmt_ap_t_modifier': 270.0,
        # --- Electron afterpulses ---
        'photoionization_modifier': 1.0,
        'photoelectric_modifier': 1.0,
        'photoelectric_p': 0.001,
        'photoelectric_t_center': -800.0,
        'photoelectric_t_spread': 250.0,
        # --- Digitizer ---
        'sample_duration': 10,
        'samples_before_pulse_center': 2,
        'samples_after_pulse_center': 20,
        'samples_to_store_before': 50,
        'samples_to_store_after': 50,
        'pmt_circuit_load_resistor': 8.010882825e-9,
        'external_amplification': 10,
        'high_energy_deamplification_factor': 0.05,
        'trigger_window': 50,
        'digitizer_bits': 14,
        'digitizer_reference_baseline': 16000,
        'digitizer_voltage_range': 2.25,
        'zle_threshold': 15,
        'special_thresholds': {},
        # --- Plugin-level options ---
        'event_rate': 1000,
        'chunk_size': 100,
        'n_chunk': 10,
        'right_raw_extension': 100000,
        'per_pmt_truth': False,
        # One truth row per s1/s2 instruction — this IS the reference default
        # (`config.get('save_full_truth', True)`, rawdata.py:42); False gives
        # the grouped mode (S1s within 100 ns / S2s within 2 mm summarized,
        # rawdata.py:110-123). Grouping parity: tests/test_pipeline.py.
        'save_full_truth': True,
        'seed': False,
        'fax_file': None,
        'fax_config_override': None,
        'fax_config_override_from_cmt': None,
        # default gains: ~2e6 electrons / PE on every channel
        'gains': [2.0e6] * n_pmts,
    }
    c.update(layout)
    c['channel_map'] = dict(layout['channel_map'])
    c.update(overrides)
    return finalize_config(c)


def detector_physics_overrides(s2_pattern_map: str) -> dict:
    """The ``detector_physics`` switches on top of :func:`default_config`:
    NEST S1 timing, garfield gas-gap luminescence (synthetic table),
    transverse diffusion, AFT smearing, inverse FDC with a constant dummy
    map and an S2 pattern map read from the file ``s2_pattern_map`` (see
    ``resources.synthetic.write_pattern_map``).  The diffusion constant is
    an order-of-magnitude liquid-xenon value (~50 cm^2/s), the AFT values
    illustrative; neither is a calibration."""
    return dict(s1_model_type='nest',
                s2_luminescence_model='garfield_gas_gap',
                diffusion_constant_transverse=5.0e-8,     # cm^2/ns
                s2_aft_sigma=0.02, s2_aft_skewness=-1.4,
                field_distortion_model='inverse_fdc',
                fdc_3d=['constant dummy', 0.5, []],
                s2_pattern_map=str(s2_pattern_map))


def he_full_grid_overrides(aux_dir) -> dict:
    """The ``he_full_grid`` switches on top of :func:`default_config`: the
    realistic detector effects (noise, PMT and electron afterpulses), the
    three resource files of ``resources.synthetic.write_production_files``
    read from ``aux_dir`` (an 801-channel noise bank, the PMT-afterpulse
    CDFs, an SPE spectrum csv) and a high-energy deamplification factor of
    1.0.  The factor goes through the reference's integer cast
    (rawdata.py:242), so 1.0 is the smallest value that keeps the HE
    copies and the bottom-array sum alive; it is not a calibration (the
    default 0.05 casts to 0)."""
    from pathlib import Path
    from .resources.synthetic import PRODUCTION_FILES
    return dict(enable_noise=True, enable_pmt_afterpulses=True,
                enable_electron_afterpulses=True,
                url_base=str(Path(aux_dir).resolve()),
                high_energy_deamplification_factor=1.0,
                **PRODUCTION_FILES)


def timing_models_overrides(s2_luminescence) -> dict:
    """The ``timing_models`` switches on top of :func:`default_config`:
    the ``custom`` S1 timing model (a delay per recoil class: ER excimers
    and recombination, NR, alpha, LED) and the ``garfield`` S2
    luminescence model, whose wire-distance table is ``s2_luminescence``:
    a file (see ``resources.synthetic.write_garfield_table``) or an
    in-memory ``{'t': (R, M), 'x': (R,)}`` table."""
    return dict(s1_model_type='custom', s2_luminescence_model='garfield',
                s2_luminescence=(str(s2_luminescence)
                                 if not isinstance(s2_luminescence, dict)
                                 else s2_luminescence))


def field_maps_overrides(aux_dir) -> dict:
    """The ``field_maps`` switches on top of :func:`default_config`, each
    map read from a file in ``aux_dir`` (see
    ``resources.synthetic.write_field_maps``): the S1 optical propagation
    spline with ``simple`` timing, the S2 one as the S2 time model, COMSOL
    field distortion, gas-gap warping of the ``simple`` luminescence,
    every field-dependency map (drift speed with ``norm_drift_velocity``,
    survival, longitudinal and transverse diffusion), and the se-gain map
    as the light yield and, with g2, the extraction efficiency.  ``g2_mean``
    16.5 PE an electron is about XENONnT's first science run's; over the
    ~31-photon se gain it makes an extraction efficiency of ~0.53.  The
    maps are illustrative, not a calibration."""
    from pathlib import Path
    from .resources.synthetic import FIELD_MAP_FILES
    return dict(s1_model_type='optical_propagation+simple',
                s2_time_model='optical_propagation',
                field_distortion_model='comsol',
                s2_luminescence_model='simple',
                enable_gas_gap_warping=True,
                enable_field_dependencies={
                    'drift_speed_map': True,
                    'survival_probability_map': True,
                    'diffusion_longitudinal_map': True,
                    'diffusion_transverse_map': True,
                    'norm_drift_velocity': True},
                se_gain_from_map=True, ext_eff_from_map=True, g2_mean=16.5,
                url_base=str(Path(aux_dir).resolve()),
                **FIELD_MAP_FILES)


def finalize_config(c: dict) -> dict:
    """Fill derived keys (reference: wfsim/strax_interface.py:572-595 and
    wfsim/core/pulse.py:31-35). Idempotent."""
    # Back-compat shim
    if 'field_distortion_on' in c and 'field_distortion_model' not in c:
        c['field_distortion_model'] = ('inverse_fdc' if c['field_distortion_on']
                                       else 'none')
    c.setdefault('field_distortion_model', 'none')

    layout = CHANNEL_MAPS.get(c.get('detector', 'XENONnT'))
    if layout is not None:
        c.setdefault('channel_map', dict(layout['channel_map']))
        c.setdefault('n_tpc_pmts', layout['n_tpc_pmts'])
        c.setdefault('n_top_pmts', layout['n_top_pmts'])
        c.setdefault('n_digitizer_channels', layout['n_digitizer_channels'])
    c['channel_map'] = dict(c['channel_map'])
    c['channel_map'].setdefault('sum_signal', 800)

    # gains from to_pe if provided (reference: strax_interface.py:580-587)
    if 'gains' not in c and 'to_pe' in c:
        to_pe = np.asarray(c['to_pe'], dtype=np.float64)
        adc_2_current = (c['digitizer_voltage_range']
                         / 2 ** c['digitizer_bits']
                         / c['pmt_circuit_load_resistor'])
        c['gains'] = np.divide(adc_2_current, to_pe,
                               out=np.zeros_like(to_pe), where=to_pe != 0)
    gains = np.asarray(c['gains'], dtype=np.float64)
    c['gains'] = gains
    c['turned_off_pmts'] = np.arange(len(gains))[gains == 0]
    c['channels_bottom'] = np.arange(c['n_top_pmts'], c['n_tpc_pmts'])
    c['current_2_adc'] = (c['pmt_circuit_load_resistor']
                          * c['external_amplification']
                          / (c['digitizer_voltage_range']
                             / 2 ** c['digitizer_bits']))
    if isinstance(c.get('enable_field_dependencies'), dict):
        for k in ('survival_probability_map', 'drift_speed_map',
                  'diffusion_longitudinal_map', 'diffusion_transverse_map'):
            c['enable_field_dependencies'].setdefault(k, False)
    return c


def deterministic_hash(obj, length: int = 10) -> str:
    """Deterministic content hash of (nested) config structures, used to key
    resource caches (same role as strax.deterministic_hash in the reference)."""
    def _canon(o):
        if isinstance(o, dict):
            return {str(k): _canon(v) for k, v in sorted(o.items(), key=lambda kv: str(kv[0]))}
        if isinstance(o, (list, tuple)):
            return [_canon(v) for v in o]
        if isinstance(o, np.ndarray):
            return ['__ndarray__', str(o.dtype), o.shape,
                    hashlib.sha1(np.ascontiguousarray(o).tobytes()).hexdigest()]
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if callable(o):
            return f'__callable__:{getattr(o, "__name__", repr(o))}'
        return o
    blob = json.dumps(_canon(obj), sort_keys=True, default=repr).encode()
    return hashlib.sha1(blob).hexdigest()[:length]
