"""Global numeric configuration (counterpart of ``moby_tpu/config.py``).

The simulation core preserves the dtype of its inputs. `SceneBuilder.compile` consults
:func:`default_dtype`: float32 on the card, float64 when the caller asks for
the CPU (the regression mode the parity tests run in). ``near_zero`` mirrors
the reference's ``NEAR_ZERO`` constant (``include/Moby/Constants.h:21``,
sqrt of machine epsilon) per dtype.
"""

from __future__ import annotations

import numpy as np
import torch

# Reference: include/Moby/Constants.h:21  (sqrt of double-precision epsilon)
NEAR_ZERO_F64 = float(np.sqrt(np.finfo(np.float64).eps))
NEAR_ZERO_F32 = float(np.sqrt(np.finfo(np.float32).eps))

_NP_OF_TORCH = {torch.float32: np.float32, torch.float64: np.float64}
_TORCH_OF_NP = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


def resolve_device(device) -> torch.device:
    """An explicit ``torch.device``; a CUDA request without a card raises
    instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' for the float64 regression mode"
        )
    return dev


def default_dtype(device) -> torch.dtype:
    """float32 on the card, float64 on the CPU (regression mode)."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32


def torch_dtype(dtype) -> torch.dtype:
    """Accept a torch or numpy floating dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_OF_NP[np.dtype(dtype)]


def numpy_dtype(dtype):
    """The numpy dtype of a torch (or numpy) floating dtype."""
    if isinstance(dtype, torch.dtype):
        return _NP_OF_TORCH[dtype]
    return np.dtype(dtype).type


def near_zero(dtype) -> float:
    """Dtype-appropriate NEAR_ZERO (sqrt eps), mirroring Moby's constant."""
    if numpy_dtype(dtype) == np.float64:
        return NEAR_ZERO_F64
    return NEAR_ZERO_F32


def eps(dtype) -> float:
    """Machine epsilon of a floating dtype."""
    return float(np.finfo(numpy_dtype(dtype)).eps)
