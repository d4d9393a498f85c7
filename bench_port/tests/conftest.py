"""Shared pieces of the benchmark's CPU tests: a tiny stream of each cell
run through the whole harness on the CPU (the program's plain twins)."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: a stream small enough for the CPU twins: 40 events, super-batches of a
#: few events, chunks of 4 ms
TINY = dict(n_events=40,
            overrides=dict(chunk_size=0.004, pipeline_depth=6,
                           pipeline_min_batch=8))


def tiny_run(tmp_path, workload='nt_he_grid.er', seed=7, captures=1, **kw):
    """One run of ``workload`` on the CPU at the tiny size; the compared
    batches (``captures`` of them) are drawn from the stream's second and
    third rounds and the production files go under ``tmp_path``."""
    from bench_port import harness
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, 'CACHE', Path(tmp_path))
        mp.setattr(harness, 'CAPTURE_FIRST', 1)
        mp.setattr(harness, 'CAPTURE_ROUNDS', 2)
        mp.setattr(harness, 'CAPTURES', captures)
        mp.setattr(harness, 'TRACE_FIRST', 1)
        mp.setattr(harness, 'TRACE_BURSTS', 1)
        return harness.run_cell(workload, seed, 0.0, kw.pop('trace', False),
                                device='cpu', **TINY, **kw)


@pytest.fixture(scope='session')
def sound_and_control(tmp_path_factory):
    """A sound run of the full-grid cell with the control's numbers."""
    return tiny_run(tmp_path_factory.mktemp('prod'), control=True)
