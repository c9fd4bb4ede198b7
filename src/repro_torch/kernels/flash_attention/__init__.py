from repro_torch.kernels.flash_attention.ops import (attention,
                                                     attention_bwd,
                                                     attention_with_lse)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_bwd_rounded,
                                                     attention_ref,
                                                     bf16_rounding_terms,
                                                     lse2_ref)

__all__ = ["attention", "attention_bwd", "attention_bwd_ref",
           "attention_bwd_rounded", "attention_ref", "attention_with_lse",
           "bf16_rounding_terms", "lse2_ref"]
