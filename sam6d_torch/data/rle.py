"""Host RLE codecs for the ISM -> PEM json boundary (numpy; port of the
host half of `sam6d_tpu/ops/masks.py:25-98`).

- BOP uncompressed counts: Fortran order, starting with the zero run
  (reference ISM model/utils.py:25-43).
- pycocotools-compatible compressed strings (LEB128 variant: 5 bits per
  char, +48, counts after the second stored as deltas).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def mask_to_rle_counts(mask: np.ndarray) -> Dict:
    """Binary (H, W) -> {'counts': [...], 'size': [H, W]}."""
    flat = np.asarray(mask, bool).flatten(order="F")
    diffs = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], diffs, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    return {"counts": counts, "size": list(mask.shape)}


def rle_counts_to_mask(rle: Dict) -> np.ndarray:
    """Inverse of mask_to_rle_counts."""
    h, w = rle["size"]
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for c in rle["counts"]:
        if val:
            flat[pos:pos + c] = True
        pos += c
        val = not val
    return flat.reshape((h, w), order="F")


def rle_encode_coco(mask: np.ndarray) -> Dict:
    """Binary (H, W) -> COCO compressed RLE {'counts': str, 'size': [H, W]}."""
    rle = mask_to_rle_counts(mask)
    cnts = rle["counts"]
    out = []
    for i, x in enumerate(cnts):
        if i > 2:
            x -= cnts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return {"counts": "".join(out), "size": rle["size"]}


def rle_decode_coco(rle: Dict) -> np.ndarray:
    """Decode COCO RLE: a compressed string or an uncompressed counts list."""
    counts = rle["counts"]
    if isinstance(counts, (list, tuple)):
        return rle_counts_to_mask(rle)
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    cnts: List[int] = []
    i = 0
    while i < len(counts):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(counts[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k + 5)
            k += 1
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return rle_counts_to_mask({"counts": cnts, "size": rle["size"]})
