"""dtype helpers: config dtype names -> torch dtypes."""

from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
}


def canonical_dtype(name) -> torch.dtype:
    """A config's dtype name as a torch dtype. A torch dtype passes
    through: no config names float64, but a float64 model (its config's
    ``compute_dtype=torch.float64``) is how chip_smoke.py checks the packed
    gradients past f32's rounding."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; expected one of {list(_DTYPES)}")
