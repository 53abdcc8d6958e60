"""Parameter utilities (the port's copy of `sam6d_tpu/core/params.py`)."""
from __future__ import annotations

from typing import Dict, Union

import torch
from torch import nn


def cast_float_params(module_or_state_dict: Union[nn.Module, Dict[str, torch.Tensor]],
                      dtype: torch.dtype):
    """Cast every floating parameter and buffer to `dtype` (bf16 for inference
    serving) and leave integer and bool tensors as they are.

    A module is cast in place and returned; a state dict comes back as a new
    dict. Checkpoints load as float32; for inference the compute dtype is
    bf16, and float32 masters would be re-cast in every forward (and double
    the weights' memory reads). Training keeps float32."""
    if isinstance(module_or_state_dict, nn.Module):
        # Module.to(dtype) casts only the floating parameters and buffers
        return module_or_state_dict.to(dtype)
    return {k: v.to(dtype) if torch.is_floating_point(v) else v
            for k, v in module_or_state_dict.items()}


def compute_dtype(name: str) -> torch.dtype:
    """`Config.dtype` ('float32' or 'bfloat16') as a torch dtype."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"compute dtype must be one of {sorted(dtypes)}, got {name!r}")
    return dtypes[name]
