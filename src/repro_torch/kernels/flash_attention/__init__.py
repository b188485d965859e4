from .flash_attention import flash_attention
from .ops import attention
from .ref import mha_ref
