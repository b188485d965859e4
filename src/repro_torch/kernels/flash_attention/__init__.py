from .flash_attention import (HEAD_DIMS, FlashAttention, consumer_warpgroups,
                              flash_attention, plain_attention)
from .ops import attention, set_head_sharded_attention
from .ref import blocked_mha, blocked_mha_heads, mha_ref
