"""Numerical-safety guards (port of the JAX package's ``utils/debug.py``:
the reference's one-off DMC NaN sanitization, vmc_dmc...:250-253, made a
utility).

The JAX package's ``debug_mode`` (``jax_debug_nans`` / ``_infs``: trap at
the op that produced a NaN) has no counterpart: PyTorch has nothing that
traps the forward op that made a NaN (``torch.autograd.detect_anomaly``
checks backward passes only). Use :func:`assert_finite` at the points to
check.

A tree here is a tensor, or a dict, list, tuple or dataclass of trees;
other leaves are skipped, as JAX skips leaves that are not arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Tuple

import torch


def _leaves_with_path(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in JAX's order and ``keystr`` notation: dict
    keys sorted, ``['key']``; sequence items ``[i]``; dataclass fields
    ``.name``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves_with_path(getattr(tree, f.name), f"{path}.{f.name}")
    else:
        yield path, tree


def _inexact(leaf: Any) -> bool:
    return isinstance(leaf, torch.Tensor) and (leaf.is_floating_point() or leaf.is_complex())


def all_finite(tree: Any) -> torch.Tensor:
    """0-d bool tensor: every floating leaf of the tree is finite (no host
    read)."""
    out = None
    for _, leaf in _leaves_with_path(tree):
        if _inexact(leaf):
            ok = torch.all(torch.isfinite(leaf))
            out = ok if out is None else out & ok.to(out.device)
    return torch.tensor(True) if out is None else out


def assert_finite(tree: Any, name: str = "state") -> None:
    """Host-side check (reads the device): raises ``FloatingPointError``
    naming the first leaf with a NaN or Inf, as the JAX package words it."""
    for path, leaf in _leaves_with_path(tree):
        if _inexact(leaf) and not bool(torch.all(torch.isfinite(leaf))):
            raise FloatingPointError(f"non-finite values in {name}{path}")


def sanitize_weights(weights: torch.Tensor, fallback_uniform: bool = True) -> torch.Tensor:
    """The DMC weight hygiene (vmc_dmc...:250-253): NaN/Inf -> tiny,
    renormalize; a degenerate sum -> uniform (or, without
    ``fallback_uniform``, a division by max(sum, 1e-30))."""
    n = weights.shape[0]
    w = torch.nan_to_num(weights, nan=1e-9, posinf=1e-9, neginf=1e-9)
    w = torch.clamp_min(w, 0.0)
    s = torch.sum(w)
    if fallback_uniform:
        return torch.where(s > 0, w / s, torch.full_like(w, 1.0 / n))
    return w / torch.clamp_min(s, 1e-30)
