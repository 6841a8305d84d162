"""Result storage (port of ``ode_uncertainty_tpu/utils/io.py``).

H5 files with one dataset per key (``w``/``a`` modes, existing keys
replaced, generator/key entries skipped); a path ending in ``.npz`` is
written and read with numpy instead. ``h5py`` is imported only when an H5
file is actually read or written.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

_SKIPPED_KEYS = {"prng_key", "key"}


def _to_host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, torch.Generator):
        return None
    return value


def store_data(data: Dict, path: str, mode: str = "w") -> None:
    """Writes a flat dict of arrays to an H5 file (or ``.npz``)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    host = {}
    for k, v in data.items():
        if k in _SKIPPED_KEYS:
            continue
        hv = _to_host(v)
        if hv is not None:
            host[k] = hv

    if p.suffix == ".npz":
        existing = {}
        if mode == "a" and p.exists():
            with np.load(p, allow_pickle=False) as z:
                existing = {k: z[k] for k in z.files}
        existing.update(host)
        np.savez(p, **existing)
        return

    import h5py

    with h5py.File(p, mode) as h5f:
        for k, v in host.items():
            if k in h5f:
                del h5f[k]
            h5f.create_dataset(k, data=v)


def load_data(path: str) -> Dict[str, np.ndarray]:
    """Loads every dataset of an H5 (or ``.npz``) file into host arrays."""
    p = Path(path)
    if p.suffix == ".npz":
        with np.load(p, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    import h5py

    out = {}
    with h5py.File(p, "r") as h5f:

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = obj[()]

        h5f.visititems(visit)
    return out
