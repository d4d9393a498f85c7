"""Parameter bundle and scalar constants (counterpart of
wfsim_tpu/models/params.py).

``SimParams`` is a plain dataclass of device tensors: everything the
physics and the digitizer read per photon or per sample.  Nothing here is
trained, so there is no ``nn.Module``.  ``SimConstants`` is the frozen
dataclass of scalars and model switches, field for field the one of
wfsim_tpu.  ``params_from_numpy`` rebuilds both from the JAX package's
bundle exported as numpy, which the tests hold ``build_params`` against.
"""
from __future__ import annotations

import dataclasses
import typing as ty

import numpy as np
import torch

from .. import units
from ..ops.interp import GridMap
from ..ops.waveform import make_templates
from ..resources.loader import Resource, as_gridmap

__all__ = ['SimParams', 'SimConstants', 'build_params', 'build_constants',
           'params_from_numpy']


@dataclasses.dataclass
class SimParams:
    """Device tensors of one configuration (the main-path fields of
    wfsim_tpu's SimParams; the optional tables it holds for noise,
    afterpulses, NEST, garfield, field maps and optical splines are not
    ported yet)."""
    gains: torch.Tensor                # (C,) f32 electrons/PE
    uniform_to_pe: torch.Tensor        # (C, 2001) f32
    templates: torch.Tensor            # (dt, L) f32 SPE current templates
    current_max: torch.Tensor          # (dt,) f32 per-phase template peak
    trigger_thresholds: torch.Tensor   # (C,) f32 (zle or special) - 0.5
    zle_thresholds: torch.Tensor       # (C_all,) i32 digitized thresholds
    top_mask: torch.Tensor             # (C,) bool
    bottom_mask: torch.Tensor          # (C,) bool
    live_mask: torch.Tensor            # (C,) bool gains > 0
    chan_pack: torch.Tensor            # (C, 4) f32 [gain, threshold, live, bottom]
    s1_lce: GridMap
    s1_pattern: GridMap
    s2_pattern: GridMap
    s2_correction: GridMap
    se_gain: ty.Optional[GridMap]


@dataclasses.dataclass(frozen=True)
class SimConstants:
    """Frozen scalar/switch config snapshot (field for field the
    wfsim_tpu.models.params.SimConstants of the same config)."""
    detector: str
    n_tpc_pmts: int
    n_top_pmts: int
    n_channels_total: int
    he_channel_start: int
    he_channel_end: int
    sum_signal_channel: int
    sample_duration: int
    samples_before_pulse_center: int
    samples_after_pulse_center: int
    samples_to_store_before: int
    samples_to_store_after: int
    trigger_window: int
    digitizer_reference_baseline: int
    high_energy_deamp_int: int
    current_2_adc: float
    # model switches
    s1_model_type: str
    s2_time_model: str
    s2_luminescence_model: str
    field_distortion_model: str
    enable_gas_gap_warping: bool
    enable_pmt_afterpulses: bool
    enable_electron_afterpulses: bool
    enable_gate_afterpulses: bool
    enable_noise: bool
    en_survival_prob: bool
    en_drift_speed: bool
    en_diff_long: bool
    en_diff_trans: bool
    # physics scalars
    p_double_pe_emision: float
    pmt_transit_time_mean: float
    pmt_transit_time_spread: float
    s1_decay_time: float
    s1_decay_spread: float
    s1_detection_efficiency: float
    s1_ER_alpha_singlet_fraction: float
    s1_ER_primary_singlet_fraction: float
    s1_ER_recombination_fraction: float
    s1_ER_secondary_singlet_fraction: float
    s1_NR_singlet_fraction: float
    maximum_recombination_time: float
    led_pulse_length: float
    singlet_fraction_gas: float
    singlet_lifetime_gas: float
    singlet_lifetime_liquid: float
    triplet_lifetime_gas: float
    triplet_lifetime_liquid: float
    drift_field: float
    drift_velocity_liquid: float
    drift_time_gate: float
    diffusion_constant_longitudinal: float
    diffusion_constant_transverse: float
    electron_extraction_yield: float
    electron_lifetime_liquid: float
    electron_trapping_time: float
    s2_secondary_sc_gain: float
    s2_gain_spread: float
    s2_time_spread: float
    s2_aft_sigma: float
    s2_aft_skewness: float
    se_gain_from_map: bool
    ext_eff_from_map: bool
    g2_mean: float
    tpc_length: float
    tpc_radius: float
    anode_wire_radius: float
    anode_field_domination_distance: float
    elr_gas_gap_length: float
    gate_to_anode_distance: float
    anode_voltage: float
    lxe_dielectric_constant: float
    gas_drift_velocity_slope: float
    pressure: float
    temperature: float
    anode_xaxis_angle: float
    anode_pitch: float
    s2_garfield_confine_position: float
    # afterpulse scalars
    pmt_ap_modifier: float
    pmt_ap_t_modifier: float
    pmt_ap_element_uniform: ty.Tuple[bool, ...]
    pmt_ap_delay_bin: ty.Tuple[float, ...]
    pmt_ap_amp_bin: ty.Tuple[float, ...]
    photoionization_modifier: float
    photoelectric_modifier: float
    photoelectric_p: float
    photoelectric_t_center: float
    photoelectric_t_spread: float
    ele_ap_n: float
    drift_velocity_scaling: float
    per_pmt_truth: bool
    # derived recoil-model constants (reference computes these on the fly,
    # wfsim/core/s1.py:281-327)
    er_primary_excimer_fraction: float
    er_recombination_time: float


def _er_derived(config):
    """ER model derived constants (reference: wfsim/core/s1.py:289-307)."""
    density = config.get('liquid_density', 1.872452802978054e+30) / (units.g / units.cm ** 3)
    excfrac = 0.4 - 0.11131 * density - 0.0026651 * density ** 2
    excfrac = 1 / (1 + excfrac)
    excfrac /= 1 - (1 - excfrac) * (1 - config['s1_ER_recombination_fraction'])
    efield = config['drift_field'] / (units.V / units.cm)
    reco_time = 3.5 / 0.18 * (1 / 20 + 0.41) * np.exp(-0.009 * efield)
    return float(excfrac), float(reco_time)


def build_constants(config) -> SimConstants:
    cm = config['channel_map']
    he = cm.get('he', (0, -1))
    efd = config.get('enable_field_dependencies', {}) or {}
    excfrac, reco_time = _er_derived(config)

    # PMT AP element metadata (static ordering)
    ap_uniform, ap_dbin, ap_abin = (), (), ()
    if config.get('enable_pmt_afterpulses', False):
        ap = config.get('_pmt_ap_elements')
        if ap:
            ap_uniform = tuple(bool(e['uniform']) for e in ap)
            ap_dbin = tuple(float(e['delaytime_bin_size']) for e in ap)
            ap_abin = tuple(float(e['amplitude_bin_size']) for e in ap)

    return SimConstants(
        detector=config['detector'],
        n_tpc_pmts=int(config['n_tpc_pmts']),
        n_top_pmts=int(config['n_top_pmts']),
        n_channels_total=int(config.get('n_digitizer_channels', 801)),
        he_channel_start=int(he[0]),
        he_channel_end=int(he[1]),
        sum_signal_channel=int(cm.get('sum_signal', 800)),
        sample_duration=int(config['sample_duration']),
        samples_before_pulse_center=int(config['samples_before_pulse_center']),
        samples_after_pulse_center=int(config['samples_after_pulse_center']),
        samples_to_store_before=int(config['samples_to_store_before']),
        samples_to_store_after=int(config['samples_to_store_after']),
        trigger_window=int(config['trigger_window']),
        digitizer_reference_baseline=int(config['digitizer_reference_baseline']),
        high_energy_deamp_int=int(config['high_energy_deamplification_factor']),
        current_2_adc=float(config['current_2_adc']),
        s1_model_type=str(config['s1_model_type']),
        s2_time_model=str(config['s2_time_model']),
        s2_luminescence_model=str(config['s2_luminescence_model']),
        field_distortion_model=str(config.get('field_distortion_model', 'none')),
        enable_gas_gap_warping=bool(config.get('enable_gas_gap_warping', False)),
        enable_pmt_afterpulses=bool(config.get('enable_pmt_afterpulses', False)),
        enable_electron_afterpulses=bool(config.get('enable_electron_afterpulses', False)),
        enable_gate_afterpulses=bool(config.get('enable_gate_afterpulses', False)),
        enable_noise=bool(config.get('enable_noise', False)),
        en_survival_prob=bool(efd.get('survival_probability_map', False)),
        en_drift_speed=bool(efd.get('drift_speed_map', False)),
        en_diff_long=bool(efd.get('diffusion_longitudinal_map', False)),
        en_diff_trans=bool(efd.get('diffusion_transverse_map', False)),
        p_double_pe_emision=float(config['p_double_pe_emision']),
        pmt_transit_time_mean=float(config['pmt_transit_time_mean']),
        pmt_transit_time_spread=float(config['pmt_transit_time_spread']),
        s1_decay_time=float(config.get('s1_decay_time', 0.0)),
        s1_decay_spread=float(config.get('s1_decay_spread', 0.0)),
        s1_detection_efficiency=float(config.get('s1_detection_efficiency', 1.0)),
        s1_ER_alpha_singlet_fraction=float(config.get('s1_ER_alpha_singlet_fraction', 0.0)),
        s1_ER_primary_singlet_fraction=float(config.get('s1_ER_primary_singlet_fraction', 0.0)),
        s1_ER_recombination_fraction=float(config.get('s1_ER_recombination_fraction', 0.0)),
        s1_ER_secondary_singlet_fraction=float(config.get('s1_ER_secondary_singlet_fraction', 0.0)),
        s1_NR_singlet_fraction=float(config.get('s1_NR_singlet_fraction', 0.0)),
        maximum_recombination_time=float(config.get('maximum_recombination_time', 10000.0)),
        led_pulse_length=float(config.get('led_pulse_length', 100.0)),
        singlet_fraction_gas=float(config.get('singlet_fraction_gas', 0.0)),
        singlet_lifetime_gas=float(config.get('singlet_lifetime_gas', 0.0)),
        singlet_lifetime_liquid=float(config.get('singlet_lifetime_liquid', 0.0)),
        triplet_lifetime_gas=float(config.get('triplet_lifetime_gas', 0.0)),
        triplet_lifetime_liquid=float(config.get('triplet_lifetime_liquid', 0.0)),
        drift_field=float(config['drift_field']),
        drift_velocity_liquid=float(config['drift_velocity_liquid']),
        drift_time_gate=float(config['drift_time_gate']),
        diffusion_constant_longitudinal=float(config['diffusion_constant_longitudinal']),
        diffusion_constant_transverse=float(config.get('diffusion_constant_transverse', 0.0)),
        electron_extraction_yield=float(config['electron_extraction_yield']),
        electron_lifetime_liquid=float(config['electron_lifetime_liquid']),
        electron_trapping_time=float(config['electron_trapping_time']),
        s2_secondary_sc_gain=float(config['s2_secondary_sc_gain']),
        s2_gain_spread=float(config.get('s2_gain_spread', 0.0)),
        s2_time_spread=float(config.get('s2_time_spread', 0.0)),
        s2_aft_sigma=float(config.get('s2_aft_sigma', 0.0)),
        s2_aft_skewness=float(config.get('s2_aft_skewness', 0.0)),
        se_gain_from_map=bool(config.get('se_gain_from_map', False)),
        ext_eff_from_map=bool(config.get('ext_eff_from_map', False)),
        g2_mean=float(config.get('g2_mean', 0.0)),
        tpc_length=float(config['tpc_length']),
        tpc_radius=float(config['tpc_radius']),
        anode_wire_radius=float(config['anode_wire_radius']),
        anode_field_domination_distance=float(config['anode_field_domination_distance']),
        elr_gas_gap_length=float(config['elr_gas_gap_length']),
        gate_to_anode_distance=float(config['gate_to_anode_distance']),
        anode_voltage=float(config['anode_voltage']),
        lxe_dielectric_constant=float(config['lxe_dielectric_constant']),
        gas_drift_velocity_slope=float(config['gas_drift_velocity_slope']),
        pressure=float(config['pressure']),
        temperature=float(config['temperature']),
        anode_xaxis_angle=float(config.get('anode_xaxis_angle', np.pi / 4)),
        anode_pitch=float(config.get('anode_pitch', 0.5)),
        s2_garfield_confine_position=float(config.get('s2_garfield_confine_position', -1.0)),
        pmt_ap_modifier=float(config.get('pmt_ap_modifier', 1.0)),
        pmt_ap_t_modifier=float(config.get('pmt_ap_t_modifier', 0.0)),
        pmt_ap_element_uniform=ap_uniform,
        pmt_ap_delay_bin=ap_dbin,
        pmt_ap_amp_bin=ap_abin,
        photoionization_modifier=float(config.get('photoionization_modifier', 1.0)),
        photoelectric_modifier=float(config.get('photoelectric_modifier', 1.0)),
        photoelectric_p=float(config.get('photoelectric_p', 0.0)),
        photoelectric_t_center=float(config.get('photoelectric_t_center', 0.0)),
        photoelectric_t_spread=float(config.get('photoelectric_t_spread', 0.0)),
        ele_ap_n=float(config.get('_ele_ap_n', 0.0)),
        drift_velocity_scaling=float(config.get('_drift_velocity_scaling', 1.0)),
        per_pmt_truth=bool(config.get('per_pmt_truth', False)),
        er_primary_excimer_fraction=excfrac,
        er_recombination_time=reco_time,
    )



def build_params(config, resource: Resource, device) -> SimParams:
    """Assemble the device parameter bundle (wfsim_tpu build_params)."""
    device = torch.device(device)
    n_pmts = int(config['n_tpc_pmts'])
    n_all = int(config.get('n_digitizer_channels', 801))
    gains = np.asarray(config['gains'], dtype=np.float32)
    templates = make_templates(
        config['pe_pulse_ts'], config['pe_pulse_ys'],
        sample_duration=int(config['sample_duration']),
        samples_before=int(config['samples_before_pulse_center']),
        samples_after=int(config['samples_after_pulse_center']))
    current_max = templates.max(axis=1)

    # trigger thresholds for the truth counters (reference: pulse.py:240-243)
    thr = np.full(n_pmts, float(config['zle_threshold']) - 0.5, dtype=np.float32)
    # digitized ZLE thresholds (reference: rawdata.py:290-294)
    zle_thr = np.full(n_all,
                      int(config['digitizer_reference_baseline'])
                      - int(config['zle_threshold']) - 1, dtype=np.int32)
    for ch_str, v in (config.get('special_thresholds') or {}).items():
        ch = int(ch_str)
        if ch < n_pmts:
            thr[ch] = float(v) - 0.5
        if ch < n_all:
            zle_thr[ch] = int(config['digitizer_reference_baseline']) - int(v) - 1

    top_mask = np.zeros(n_pmts, bool)
    top_mask[:int(config['n_top_pmts'])] = True
    bottom_mask = ~top_mask
    live = gains > 0
    chan_pack = np.stack([gains, thr, live.astype(np.float32),
                          bottom_mask.astype(np.float32)], axis=1)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    def g(m, ndim):
        gm = as_gridmap(m, ndim_in=ndim)
        return gm.to(device) if gm is not None else None

    return SimParams(
        gains=t(gains),
        uniform_to_pe=t(np.asarray(resource.uniform_to_pe, np.float32)),
        templates=t(templates),
        current_max=t(current_max),
        trigger_thresholds=t(thr),
        zle_thresholds=t(zle_thr),
        top_mask=t(top_mask),
        bottom_mask=t(bottom_mask),
        live_mask=t(live),
        chan_pack=t(chan_pack.astype(np.float32)),
        s1_lce=g(resource.s1_lce_correction_map, 3),
        s1_pattern=g(resource.s1_pattern_map, 3),
        s2_pattern=g(resource.s2_pattern_map, 2),
        s2_correction=g(resource.s2_correction_map, 2),
        se_gain=g(getattr(resource, 'se_gain_map', None), 2),
    )


def params_from_numpy(tree: ty.Dict[str, np.ndarray], const_fields: dict,
                      device):
    """Rebuild (SimParams, SimConstants) from wfsim_tpu's bundle exported
    as numpy: ``tree[name]`` for array fields and ``tree[name + '.values']``,
    ``'.lows'``, ``'.highs'`` for GridMap fields (the GridMap pytree leaf
    order); absent names are None.  Raises if the tree holds a field the
    port does not carry."""
    device = torch.device(device)
    names = {f.name for f in dataclasses.fields(SimParams)}
    extra = {k.split('.')[0] for k in tree} - names
    if extra:
        raise NotImplementedError(f'fields not ported: {sorted(extra)}')
    kw = {}
    for name in names:
        if name in tree:
            kw[name] = torch.as_tensor(np.array(tree[name]), device=device)
        elif name + '.values' in tree:
            kw[name] = GridMap(*(torch.as_tensor(
                np.array(tree[f'{name}.{part}']), device=device)
                for part in ('values', 'lows', 'highs')))
        else:
            kw[name] = None
    return SimParams(**kw), SimConstants(**const_fields)
