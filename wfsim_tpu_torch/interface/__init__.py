from .simulator import Simulator  # noqa: F401
from .instructions import bench_instructions  # noqa: F401
