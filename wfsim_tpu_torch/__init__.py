"""wfsim_tpu_torch — the waveform simulator of wfsim_tpu in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

Same I/O contracts as wfsim_tpu: energy-deposit instructions in, strax
``raw_records`` and per-interaction ``truth`` out, with the same dtypes,
config keys and public names.  Every tensor lives on the ``torch.device``
passed to :class:`Simulator`; CPU tensors run the kernels' plain PyTorch
twins, CUDA tensors the kernels of ``csrc/``.  The package never imports
JAX or wfsim_tpu.
"""
__version__ = '0.1.0'

from .units import *                        # noqa: F401,F403
from . import units                         # noqa: F401
from .dtypes import (                       # noqa: F401
    instruction_dtype, truth_extra_dtype, extra_truth_dtype_per_pmt,
    raw_record_dtype, DEFAULT_RECORD_LENGTH, PULSE_TYPE_NAMES)
from .config import (                       # noqa: F401
    default_config, load_fax_config, finalize_config, deterministic_hash)
from .resources import Resource, load_config, make_map, DummyMap  # noqa: F401
from .pipeline import RawData, ChunkRawRecords  # noqa: F401
from .interface import Simulator            # noqa: F401
