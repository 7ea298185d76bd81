"""Carries state across from the JAX package (pilosa_tpu) to this port.

The two packages share their on-disk format (roaring fragment files, WAL,
sqlite attribute and key stores) and their stack layout (uint32[S, R, W]
words, here held as int32 tensors with the same bits). These helpers are
the port's counterpart of loading a model's weights: the tests use them to
feed both packages the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.core.holder import Holder


def stack_from_reference(words: np.ndarray, device="cuda") -> torch.Tensor:
    """uint32[S, R, W] stack (as the JAX package packs it) -> int32 tensor
    with the same bits on `device`."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    return torch.from_numpy(words.view(np.int32)).to(device)


def stack_to_reference(stack: torch.Tensor) -> np.ndarray:
    """Inverse of stack_from_reference: the tensor's words as uint32 on the
    host."""
    if stack.dtype != torch.int32:
        raise TypeError(f"expected an int32 stack, got {stack.dtype}")
    return stack.detach().cpu().contiguous().numpy().view(np.uint32)


def open_reference_holder(path: str) -> Holder:
    """Open a data directory that the JAX package's Holder wrote."""
    return Holder(path).open()
