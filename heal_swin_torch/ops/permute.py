"""Token permutation for the shifted-window strategies (counterpart of
``heal_swin_tpu/ops/permute.py``).

``permute_tokens`` gathers rows of (B, N, C) along the token axis with a fixed
per-sample permutation, as one ``index_select`` on the flat (B*N, C) view with
per-sample row offsets.  Its backward is the gather by the inverse permutation, as
the JAX package's custom VJP (an ``index_select``'s own backward would be a
scatter-add).
"""

from __future__ import annotations

import torch


def _gather(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    B, N, C = x.shape
    rows = (perm[None, :] + torch.arange(B, device=x.device)[:, None] * N).reshape(-1)
    return x.reshape(B * N, C).index_select(0, rows).reshape(B, N, C)


class _PermuteTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return _gather(x, perm)

    @staticmethod
    def backward(ctx, dy):
        (inv_perm,) = ctx.saved_tensors
        return _gather(dy.contiguous(), inv_perm), None, None


def permute_tokens(x: torch.Tensor, perm: torch.Tensor, inv_perm: torch.Tensor) -> torch.Tensor:
    """y[b, i] = x[b, perm[i]] for x (B, N, C) and perm (N,) int64 on x's device;
    ``inv_perm``, the inverse permutation, is the backward's gather."""
    return _PermuteTokens.apply(x, perm, inv_perm)
