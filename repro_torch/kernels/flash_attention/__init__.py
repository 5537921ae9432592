from .flash_attention import flash_attention_plain, flash_attention_raw
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["attention_ref", "flash_attention", "flash_attention_plain",
           "flash_attention_raw"]
