"""Multi-device runs over torch.distributed (counterpart of
wfsim_tpu/parallel)."""
from .sharding import make_mesh, make_sharded_step  # noqa: F401
