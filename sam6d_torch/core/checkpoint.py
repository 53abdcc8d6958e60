"""Template onboarding caches (npz), the port's copy of the cache half of
`sam6d_tpu/core/checkpoint.py`: the reference keeps descriptors.pth /
descriptors_appe.pth beside the templates (`model/detector.py:76-128`),
invalidated by `reset_descriptors`. Same keys and format as the JAX
package's, so a cache written by either loads into the other.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def save_template_cache(cache_path: str, **arrays) -> None:
    """np.savez of the named arrays (host arrays or tensors on any device)."""
    os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
    np.savez(cache_path, **{k: v.detach().cpu().numpy() if hasattr(v, "detach")
                            else np.asarray(v) for k, v in arrays.items()})


def load_template_cache(cache_path: str) -> Optional[Dict[str, np.ndarray]]:
    """The cached arrays, or None when there is no cache file."""
    if not os.path.exists(cache_path):
        return None
    with np.load(cache_path) as data:
        return {k: data[k] for k in data.files}
