from .flash_decode import flash_decode_plain, flash_decode_raw
from .ops import flash_decode
from .ref import decode_attention_ref

__all__ = ["decode_attention_ref", "flash_decode", "flash_decode_plain",
           "flash_decode_raw"]
