"""StructuredModel: the user/item split of sequence scoring, port of
``deeprec_tpu/models/structured.py``.

When B users are scored against N candidate items each, the user tower
runs once per user and its output is broadcast over that user's items
(an expanded view, no copies): ``user_fn`` takes [B, ...] user inputs,
``item_fn`` [B, N, ...] item inputs, and ``join_fn`` sees the pair.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch


def structured_score(user_fn: Callable[..., torch.Tensor],
                     item_fn: Callable[..., torch.Tensor],
                     join_fn: Callable[[torch.Tensor, torch.Tensor],
                                       torch.Tensor],
                     user_inputs, item_inputs):
    """Score every (user, item) pair without recomputing the user tower.

    user_fn(user_inputs) -> [B, Du]; item_fn(item_inputs) -> [B, N, Di];
    join_fn([B, N, Du], [B, N, Di]) -> [B, N] scores.
    """
    u = user_fn(user_inputs)                       # [B, Du], computed once
    it = item_fn(item_inputs)                      # [B, N, Di]
    B, Du = u.shape
    return join_fn(u[:, None, :].expand(B, it.shape[1], Du), it)


def dot_join(u, it):
    """Inner-product join (two-tower scoring)."""
    return (u * it).sum(dim=-1)


class StructuredModel:
    """The three callables bundled: ``apply(params, user_inputs,
    item_inputs)`` evaluates the split model; gradients flow through
    both towers."""

    def __init__(self, user_fn, item_fn, join_fn=dot_join):
        self.user_fn = user_fn
        self.item_fn = item_fn
        self.join_fn = join_fn

    def apply(self, params: Dict[str, Any], user_inputs, item_inputs):
        return structured_score(
            lambda ui: self.user_fn(params, ui),
            lambda ii: self.item_fn(params, ii),
            self.join_fn, user_inputs, item_inputs)
