"""Token permutation for the shifted-window strategies (counterpart of
``heal_swin_tpu/ops/permute.py``).

``permute_tokens`` gathers rows of (B, N, C) along the token axis with a fixed
per-sample permutation, as one ``index_select`` on the flat (B*N, C) view with
per-sample row offsets.  Forward only for now; the training path will give it the
inverse-permutation gather as its backward.
"""

from __future__ import annotations

import torch


def permute_tokens(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """y[b, i] = x[b, perm[i]] for x (B, N, C) and perm (N,) int64 on x's device."""
    B, N, C = x.shape
    rows = (perm[None, :] + torch.arange(B, device=x.device)[:, None] * N).reshape(-1)
    return x.reshape(B * N, C).index_select(0, rows).reshape(B, N, C)
