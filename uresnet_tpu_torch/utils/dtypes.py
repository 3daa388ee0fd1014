"""dtype helpers: config dtype names -> torch dtypes."""

from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
}


def canonical_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; expected one of {list(_DTYPES)}")
