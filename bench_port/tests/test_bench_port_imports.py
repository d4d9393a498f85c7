"""What the run imports: nothing of JAX or the JAX package, and a
reference that imports nothing of the program."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_RUN = '''
import sys
sys.path.insert(0, {root!r})
from pathlib import Path
from bench_port import harness
harness.CACHE = Path({tmp!r})
harness.CAPTURE_FIRST, harness.CAPTURE_ROUNDS, harness.CAPTURES = 1, 2, 1
out = harness.run_cell('nt_he_grid.er', 3, 0.0, False, device='cpu',
                       n_events=24, overrides=dict(
                           chunk_size=0.004, pipeline_depth=6,
                           pipeline_min_batch=8))
assert out['correct'], out['checks']
bad = harness.forbidden_modules()
print('FORBIDDEN', bad)
'''


def _python(code):
    return subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)


def test_no_jax_after_a_run(tmp_path):
    got = _python(TINY_RUN.format(root=str(ROOT), tmp=str(tmp_path)))
    assert got.returncode == 0, got.stderr[-3000:]
    assert 'FORBIDDEN []' in got.stdout


def test_forbidden_names_compare_whole_top_level_names():
    from bench_port import harness
    saved = dict(sys.modules)
    try:
        sys.modules['wfsim_tpu_torch_probe'] = sys
        sys.modules['jaxlib_like'] = sys
        sys.modules['jax.probe'] = sys
        found = harness.forbidden_modules()
        assert 'jax.probe' in found
        assert 'wfsim_tpu_torch_probe' not in found
        assert 'jaxlib_like' not in found
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]


def test_reference_imports_nothing_of_the_program():
    code = ('import sys; sys.path.insert(0, %r); '
            'import bench_port.reference, bench_port.physics, bench_port.traffic; '
            'print(sorted(m for m in sys.modules if m.split(".")[0] in '
            '("wfsim_tpu_torch", "wfsim_tpu", "jax", "jaxlib")))'
            % str(ROOT))
    got = _python(code)
    assert got.returncode == 0, got.stderr
    assert got.stdout.strip() == '[]'
    for name in ('reference.py', 'physics.py', 'traffic.py'):
        src = (ROOT / 'bench_port' / name).read_text()
        assert 'import wfsim' not in src and 'from wfsim' not in src
