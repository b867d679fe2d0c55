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


def segment_mean(x: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, include_zero: bool = True) -> torch.Tensor:
    """Segment mean.  ``include_zero=True`` is the reference's
    ``scatter(..., reduce='mean')``: ``scatter_reduce`` with
    ``include_self=True`` over a zeros output, so the zero initial value
    takes part and the denominator is ``count + 1``
    (``models/utils.py:699-701``).  Checkpoints trained with
    ``reduce_op='mean'`` depend on that quirk, which the JAX package keeps
    too (``ops/segment.py:19-34``)."""
    total = segment_sum(x, segment_ids, num_segments)
    count = segment_sum(x.new_ones(x.shape[:1]), segment_ids, num_segments)
    if include_zero:
        count = count + 1.0
    return total / count.clamp_min(1.0).reshape((-1,) + (1,) * (x.dim() - 1))
