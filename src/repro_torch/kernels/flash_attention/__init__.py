from .flash_attention import FlashAttention, flash_attention
from .ops import attention
from .ref import mha_ref
