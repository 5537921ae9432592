from .mlstm_chunk import mlstm_chunk_plain, mlstm_chunk_raw
from .ops import mlstm_chunk
from .ref import mlstm_ref

__all__ = ["mlstm_chunk", "mlstm_chunk_plain", "mlstm_chunk_raw",
           "mlstm_ref"]
