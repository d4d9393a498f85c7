from .rawdata import RawData  # noqa: F401
from .optical import RawDataOptical  # noqa: F401
from .chunker import ChunkRawRecords  # noqa: F401
from .digitize import (gather_digitize, digitize_window,  # noqa: F401
                       pack_records)

# wfsim_tpu's names of the raw-data classes
RawDataTPU = RawData
RawDataOpticalTPU = RawDataOptical
