from .rawdata import RawData  # noqa: F401
from .chunker import ChunkRawRecords  # noqa: F401
from .digitize import gather_digitize, pack_records  # noqa: F401
