from .simulator import Simulator  # noqa: F401
from .instructions import (bench_instructions,  # noqa: F401
                           detector_physics_instructions,
                           timing_models_instructions, step_instructions,
                           TIMING_MODEL_RECOILS, rand_instructions,
                           random_instructions, instruction_from_csv,
                           read_optical)
