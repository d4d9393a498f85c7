"""wfsim_tpu_torch host layer against wfsim_tpu: dtypes, the default config,
and the parameter bundle and constants built from it.

Tolerance: exact — dtypes compare equal, config values equal, and every
parameter tensor bitwise equal (float32 values compared as bits) to the
JAX package's array exported as numpy.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import torch

import wfsim_tpu.dtypes as jd
from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.models.params import (build_params as jax_build_params,
                                     build_constants as jax_build_constants)
from wfsim_tpu.ops.interp import GridMap as JaxGridMap
from wfsim_tpu.resources.loader import load_config as jax_load_config

import wfsim_tpu_torch.dtypes as td
from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.models.params import (build_params, build_constants,
                                           params_from_numpy, SimParams)
from wfsim_tpu_torch.ops.interp import GridMap
from wfsim_tpu_torch.resources import load_config

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize('name,make', [
    ('instruction', lambda m: m.instruction_dtype),
    ('truth', lambda m: m.truth_extra_dtype),
    ('truth_per_pmt', lambda m: m.extra_truth_dtype_per_pmt(494)),
    ('raw_record', lambda m: m.raw_record_dtype()),
    ('raw_record_200', lambda m: m.raw_record_dtype(200)),
])
def test_dtypes_field_by_field(name, make):
    a, b = np.dtype(make(jd)), np.dtype(make(td))
    assert a.names == b.names
    for f in a.names:
        assert a.fields[f] == b.fields[f], f
    assert a == b


@pytest.mark.parametrize('detector', ['XENONnT', 'XENON1T'])
def test_default_config_key_by_key(detector):
    a = jax_default_config(detector, seed=5)
    b = default_config(detector, seed=5)
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def export_jax_params(params) -> dict:
    """wfsim_tpu SimParams -> {name: ndarray}, GridMaps as name.values /
    .lows / .highs (their pytree leaf order); None fields are absent."""
    tree = {}
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        if v is None:
            continue
        if isinstance(v, JaxGridMap):
            for part, leaf in zip(('values', 'lows', 'highs'),
                                  jax.tree_util.tree_leaves(v)):
                tree[f'{f.name}.{part}'] = np.asarray(leaf)
        else:
            tree[f.name] = np.asarray(v)
    return tree


@pytest.fixture(scope='module')
def bundles():
    cfg_j = jax_default_config()
    jp = jax_build_params(cfg_j, jax_load_config(cfg_j))
    jc = jax_build_constants(cfg_j)
    conv = params_from_numpy(export_jax_params(jp), dataclasses.asdict(jc),
                             'cpu')
    cfg = default_config()
    own = (build_params(cfg, load_config(cfg), 'cpu'), build_constants(cfg))
    return conv, own


def _same_tensor(a: torch.Tensor, b: torch.Tensor):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b)


@pytest.mark.parametrize('field', [f.name for f in dataclasses.fields(SimParams)])
def test_build_params_matches_jax(bundles, field):
    (conv, _), (own, _) = bundles
    a, b = getattr(conv, field), getattr(own, field)
    assert (a is None) == (b is None)
    if isinstance(a, GridMap):
        for part in ('values', 'lows', 'highs'):
            _same_tensor(getattr(a, part), getattr(b, part))
    elif a is not None:
        _same_tensor(a, b)


def test_build_constants_matches_jax(bundles):
    (_, jc), (_, own) = bundles
    assert dataclasses.asdict(jc) == dataclasses.asdict(own)
    assert jc == own


def test_params_from_numpy_refuses_unported_fields():
    cfg_j = jax_default_config()
    tree = export_jax_params(jax_build_params(cfg_j, jax_load_config(cfg_j)))
    tree['noise_ext'] = np.zeros((2, 2), np.int16)
    with pytest.raises(NotImplementedError):
        params_from_numpy(tree, dataclasses.asdict(
            jax_build_constants(cfg_j)), 'cpu')


def test_unported_resources_raise():
    """A map file that resolves nowhere raises FileNotFoundError, as in
    wfsim_tpu; a noise, PMT-afterpulse, SPE or electron-afterpulse file
    that resolves nowhere takes the synthetic asset, as there.  Gas-gap
    warping and COMSOL, which raised before they were ported, now load (a
    constant gas gap, no COMSOL map) and build."""
    for entry in (dict(enable_gas_gap_warping=True),
                  dict(field_distortion_model='comsol')):
        cfg = default_config(**entry)
        params = build_params(cfg, load_config(cfg), 'cpu')
        assert (params.gas_gap_map is None) == ('comsol' in str(entry))
        assert params.fd_comsol is None
    with pytest.raises(FileNotFoundError):
        load_config(default_config(s1_pattern_map='map.json'))
    on = dict(enable_noise=True, enable_pmt_afterpulses=True,
              enable_electron_afterpulses=True)
    unset = load_config(default_config(**on))
    nowhere = load_config(default_config(
        **on, noise_file='noise.npz', photon_ap_cdfs='pmt_ap.json.gz',
        photon_area_distribution='spe.csv', ele_ap_pdfs='ele_ap.pkl'))
    assert np.array_equal(nowhere.noise_bank, unset.noise_bank)
    assert np.array_equal(nowhere.uniform_to_pe, unset.uniform_to_pe)
    assert sorted(nowhere.uniform_to_pmt_ap) == sorted(unset.uniform_to_pmt_ap)
    a, b = nowhere.uniform_to_ele_ap, unset.uniform_to_ele_ap
    assert a.n == b.n and np.array_equal(a.bin_centers, b.bin_centers)


def test_package_imports_neither_jax_nor_wfsim_tpu():
    code = ('import sys, wfsim_tpu_torch, wfsim_tpu_torch.pipeline.digitize; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "wfsim_tpu")]; '
            'assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], check=True, cwd=ROOT)
    for path in list((ROOT / 'wfsim_tpu_torch').rglob('*.py')) \
            + [ROOT / 'chip_smoke.py']:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (['import'], ['from']) and len(words) > 1:
                assert words[1].split('.')[0] not in ('jax', 'wfsim_tpu'), \
                    f'{path}: {line}'
