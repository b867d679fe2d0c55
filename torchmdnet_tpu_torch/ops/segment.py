"""Segment reductions; counterpart of ``torchmdnet_tpu/ops/segment.py``.

``num_segments`` is explicit: molecules are ``0 .. num_mols-1`` and ghost
(padding) atoms sit in the extra segment ``num_mols``, which callers drop.
"""

import torch


def segment_sum(x: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``x[i]`` into ``out[segment_ids[i]]``; trailing dims preserved."""
    out = x.new_zeros((num_segments,) + tuple(x.shape[1:]))
    return out.index_add(0, segment_ids.long(), x)
