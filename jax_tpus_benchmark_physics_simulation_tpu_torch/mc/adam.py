"""Optax's ``adam`` (0.2.6), written op for op in PyTorch.

The card has no optax, and ``torch.optim.Adam`` orders ``eps`` and the bias
corrections differently. Parameters, gradients and moments are a tree: a
tensor, or a dict of tensors. ``optax.scale_by_adam`` followed by
``scale_by_learning_rate`` computes, per leaf:

    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * g**2 + b2 * nu
    count += 1
    mu_hat = mu / (1 - b1**count)          (the same for nu_hat with b2)
    update = -lr * (mu_hat / (sqrt(nu_hat + 0) + eps))

Under ``jit``, as the JAX package's VMC runs it, XLA's algebraic simplifier
drops the ``+ 0`` and folds ``(mu / bc1) / (sqrt(nu_hat) + eps)`` into one
division, ``mu / (bc1 * (sqrt(nu_hat) + eps))``, which rounds differently
in the last bit; :func:`adam_update` computes that compiled form, which is
bit-equal to ``jax.jit(optax.adam(lr).update)`` on the CPU for a first
update. Later ones can differ in the last bits: XLA on the CPU contracts
``(1 - b1) * g + b1 * mu`` into a fused multiply-add where it can, and its
float32 ``power`` (``b1**count``, the int32 count converted to float32)
rounds differently from ``torch.pow`` from count 30 (b1 = 0.9) and 167
(b2 = 0.999). Every division divides by a tensor on the moments' device (on
the card PyTorch turns a division by a Python scalar into a multiplication
by its reciprocal).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of a tensor or a dict of tensors (and the
    trees of the same structure in ``rest``)."""
    if isinstance(tree, dict):
        return {k: fn(tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return [tree]


@dataclass
class AdamState:
    count: torch.Tensor  # 0-d int32
    mu: Any
    nu: Any


def adam_init(params) -> AdamState:
    first = tree_leaves(params)[0]
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tree_map(torch.zeros_like, params),
        nu=tree_map(torch.zeros_like, params),
    )


def adam_update(grads, state: AdamState, lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8):
    """``(updates, new_state)``, as ``optax.adam(lr).update(grads, state)``."""
    mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, grads, state.mu)
    nu = tree_map(lambda g, t: (1 - b2) * (g * g) + b2 * t, grads, state.nu)
    count = state.count + 1
    exponent = count.to(torch.float32)

    def bias(decay, t):
        b = torch.full((), decay, dtype=torch.float32, device=t.device)
        return (1 - torch.pow(b, exponent)).to(t.dtype)

    def leaf(m, v):
        denom = bias(b1, m) * (torch.sqrt(v / bias(b2, v)) + eps)
        return (m / denom) * (-lr)

    updates = tree_map(leaf, mu, nu)
    return updates, AdamState(count=count, mu=mu, nu=nu)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)
