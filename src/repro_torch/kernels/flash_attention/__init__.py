from repro_torch.kernels.flash_attention.ops import attention, attention_bwd
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)

__all__ = ["attention", "attention_bwd", "attention_bwd_ref",
           "attention_ref"]
