from .rawdata import RawData  # noqa: F401
from .chunker import ChunkRawRecords  # noqa: F401
from .digitize import (gather_digitize, digitize_window,  # noqa: F401
                       pack_records)
