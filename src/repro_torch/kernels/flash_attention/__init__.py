from repro_torch.kernels.flash_attention.ops import (
    LAUNCHES,
    flash_attention,
    flash_decode,
    prefill_variant,
    reset_launches,
)
from repro_torch.kernels.flash_attention.ref import attention_ref, decode_ref

__all__ = ["LAUNCHES", "attention_ref", "decode_ref", "flash_attention",
           "flash_decode", "prefill_variant", "reset_launches"]
