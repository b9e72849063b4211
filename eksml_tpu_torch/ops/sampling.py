"""Fixed-size random subsampling (``eksml_tpu/ops/sampling.py``).

Each candidate carries a uniform priority, non-candidates get ``-inf``,
and ``top_k`` selects: choice without replacement with static output
shapes.  Shared by RPN anchor sampling and proposal-target sampling.
The reference draws the priorities from ``jax.random`` inside; here the
caller passes them in (``MaskRCNN.make_priorities`` draws them from a
``torch.Generator``), so a test can hand both the same numbers.  Every
function takes leading batch dims.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from eksml_tpu_torch.ops.nms import top_k


def sample_by_priority(candidates: torch.Tensor, priorities: torch.Tensor,
                       k: int, limit: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pick up to ``k`` true entries of bool ``candidates [..., n]``, the
    ones with the highest ``priorities [..., n]``.

    Returns ``(idx [..., k], take [..., k])``: selected indices and which
    slots are real picks.  ``limit [...]`` (≤ k) further caps the number
    taken.  ``top_k`` breaks ties toward the lower index, as
    ``lax.top_k`` does, so even the padding slots (all ``-inf``) pick
    the indices the reference picks."""
    pri = torch.where(candidates, priorities,
                      torch.full_like(priorities, float("-inf")))
    top, idx = top_k(pri, k)
    take = torch.isfinite(top)
    if limit is not None:
        slots = torch.arange(k, device=candidates.device)
        take = take & (slots < limit[..., None])
    return idx, take


def sample_mask_by_priority(candidates: torch.Tensor,
                            priorities: torch.Tensor, k: int,
                            limit: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Same, as a boolean mask over the input."""
    idx, take = sample_by_priority(candidates, priorities, k, limit)
    return torch.zeros_like(candidates).scatter(-1, idx, take)
