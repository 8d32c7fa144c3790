from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.ops import (FLASH_ATTENTION,
                                                     flash_attention)

__all__ = ["FLASH_ATTENTION", "flash_attention", "ref"]
