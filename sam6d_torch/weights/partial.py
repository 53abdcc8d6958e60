"""Shape-checked partial loading over `state_dict`s (port of
`sam6d_tpu/weights/partial.py`, reference
`Instance_Segmentation_Model/utils/weight.py:6-38`): copy the entries of a
source whose name and shape match the target's, and report the others."""
from __future__ import annotations

import logging
from typing import Dict, Tuple

import numpy as np
import torch


def load_partial(target: Dict[str, torch.Tensor], source: Dict
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """Returns (merged state_dict, report) where report maps each target
    name to 'loaded' | 'shape_mismatch' | 'missing_in_source'. Source
    entries may be tensors or numpy arrays; a loaded entry keeps the
    target's dtype and device."""
    report: Dict[str, str] = {}
    merged: Dict[str, torch.Tensor] = {}
    for key, t in target.items():
        s = source.get(key)
        if s is None:
            report[key] = "missing_in_source"
            merged[key] = t
        elif tuple(np.shape(s)) != tuple(t.shape):
            report[key] = "shape_mismatch"
            merged[key] = t
        else:
            report[key] = "loaded"
            merged[key] = torch.as_tensor(np.asarray(s) if not isinstance(s, torch.Tensor)
                                          else s).to(dtype=t.dtype, device=t.device)
    n_loaded = sum(1 for v in report.values() if v == "loaded")
    logging.info("load_partial: %d/%d entries loaded", n_loaded, len(report))
    return merged, report
