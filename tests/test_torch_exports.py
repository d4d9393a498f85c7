"""The port's public surface against wfsim_tpu's: every name
``wfsim_tpu/__init__.py`` exports exists in ``wfsim_tpu_torch`` (the
strax plugin and context names too, with strax stood in by
tests/strax_mock), and importing the port loads none of the optional
packages the card's machine lacks."""
import subprocess
import sys
from pathlib import Path

import wfsim_tpu
import wfsim_tpu.native  # noqa: F401  (a submodule no export names)

import wfsim_tpu_torch
import wfsim_tpu_torch.native  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

#: names of wfsim_tpu's top-level namespace whose code ROADMAP lists under
#: "Code the port leaves out": none since the port has ``native``
#: (``find_intervals_below_threshold``; the transport helpers stay out)
LEFT_OUT = frozenset()


def test_every_wfsim_tpu_export_exists():
    names = {k for k in dir(wfsim_tpu) if not k.startswith('_')}
    missing = sorted(k for k in names - LEFT_OUT
                     if not hasattr(wfsim_tpu_torch, k))
    assert not missing, missing
    for alias, target in (('RawDataTPU', 'RawData'),
                          ('RawDataOpticalTPU', 'RawDataOptical')):
        assert getattr(wfsim_tpu_torch, alias) is \
            getattr(wfsim_tpu_torch, target)
    assert wfsim_tpu_torch.RawData.__module__.startswith('wfsim_tpu_torch')


def test_import_loads_no_optional_package_and_strax_names_follow():
    """In a fresh interpreter: importing the port loads none of the
    optional packages the card's machine lacks (nor JAX or wfsim_tpu);
    then, with the shim as strax and the modules reloaded, the top-level
    star imports bring the plugin and context names, as wfsim_tpu's do
    (the shim's ``wfsim_tpu.dtypes`` import is given the port's identical
    dtypes module, so no JAX is loaded)."""
    code = (
        'import sys, types, importlib, wfsim_tpu_torch as w, '
        'wfsim_tpu_torch.interface.strax_plugins as p, '
        'wfsim_tpu_torch.interface.contexts as x, '
        'wfsim_tpu_torch.dtypes as d; '
        'bad = [m for m in sys.modules if m.split(".")[0] in ("pandas", '
        '"strax", "straxen", "uproot", "nestpy", "epix", "jax", '
        '"wfsim_tpu")]; assert not bad, bad; assert not w.HAVE_STRAX; '
        'pkg = types.ModuleType("wfsim_tpu"); pkg.__path__ = []; '
        'sys.modules.update({"wfsim_tpu": pkg, "wfsim_tpu.dtypes": d}); '
        'import tests.strax_mock.strax as a, tests.strax_mock.straxen as b, '
        'tests.strax_mock.immutabledict as c; '
        'sys.modules.update(strax=a, straxen=b, immutabledict=c); '
        '[importlib.reload(m) for m in (p, x, w)]; '
        'names = p.__all__ + x.__all__; '
        'assert w.HAVE_STRAX and len(names) == 12, names; '
        'assert all(getattr(w, n) is getattr(p if n in p.__all__ else x, n) '
        'for n in names); print(sorted(names))')
    out = subprocess.run([sys.executable, '-c', code], check=True, cwd=ROOT,
                         capture_output=True, text=True).stdout
    assert 'RawRecordsFromFaxnVeto' in out and 'xenonnt_simulation' in out
