"""Numerical anomaly checks (port of ``ode_uncertainty_tpu/utils/debug.py``).

Counts of non-finite values over nested containers of tensors, and an
assertion on them. Not ported: the reference's ``debug_nans`` switch (JAX's
``jax_debug_nans``, which stops at the forward operation that made the first
NaN; PyTorch has none) and ``tap_stats`` (a print no code calls).
"""

from __future__ import annotations

from typing import Any, Iterator

import torch


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):  # NamedTuples included
        for v in tree:
            yield from _tensors(v)


def count_nonfinite(tree: Any) -> torch.Tensor:
    """Total count of non-finite elements over the floating-point tensors of a
    nested dict/list/tuple (a tensor on their device; no host read)."""
    counts = [torch.sum(~torch.isfinite(t)) for t in _tensors(tree) if t.is_floating_point()]
    if not counts:
        return torch.zeros((), dtype=torch.int64)
    return sum(counts[1:], counts[0])


def assert_finite(tree: Any, label: str = "state") -> None:
    """Raises ``FloatingPointError`` if any value is non-finite (reads the
    count on the host: one synchronization per call)."""
    count = int(count_nonfinite(tree))
    if count > 0:
        raise FloatingPointError(f"{label}: {count} non-finite values")

