"""NMS problems shared by the CPU parity tests and the card's kernel tests
(numpy only, so the `cuda` test file, which imports no JAX, takes them
too): (boxes (N, 4) xyxy float32, scores (N,) float32, valid (N,) bool,
groups (N,) int, the rounds the fixed point takes or None)."""
import numpy as np


def random_boxes(rng, n, size=512.0):
    xy = rng.rand(n, 2) * size
    wh = rng.rand(n, 2) * size / 4 + 1.0
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def chain_boxes(n_chain, n):
    """n boxes: the first n_chain a chain along x in which each overlaps
    only its neighbours (IoU 0.6), scores falling along it, the rest apart:
    greedy NMS keeps every other link, deciding one a round."""
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        x = 4.0 * i if i < n_chain else 10_000.0 + 40.0 * i
        boxes[i] = [x, 0.0, x + 16.0, 16.0]
    scores = np.linspace(1.0, 0.5, n).astype(np.float32)
    return boxes, scores


def nms_case(case):
    rng = np.random.RandomState(sum(map(ord, case)))
    if case == "random_3072":
        n = 3072
        return (random_boxes(rng, n), rng.rand(n).astype(np.float32), rng.rand(n) > 0.1,
                np.zeros(n, np.int64), None)
    if case == "groups_512":
        n = 512
        return (random_boxes(rng, n, 256.0), rng.rand(n).astype(np.float32),
                rng.rand(n) > 0.2, rng.randint(0, 4, n), None)
    if case == "chain_half":
        n = 256
        boxes, scores = chain_boxes(n // 2, n)
        return boxes, scores, np.ones(n, bool), np.zeros(n, np.int64), n // 2
    if case == "all_invalid":
        n = 128
        return (random_boxes(rng, n), rng.rand(n).astype(np.float32), np.zeros(n, bool),
                np.zeros(n, np.int64), 0)
    if case == "tied_scores":                # ties go to the lower index
        n = 300
        return (random_boxes(rng, n, 128.0), np.round(rng.rand(n), 1).astype(np.float32),
                rng.rand(n) > 0.1, rng.randint(0, 2, n), None)
    if case == "single":
        return (random_boxes(rng, 1), np.ones(1, np.float32), np.ones(1, bool),
                np.zeros(1, np.int64), 1)
    if case == "isolated_128":               # the ISM capacity at the bench's load
        n = 128
        return (random_boxes(rng, n, 2048.0), rng.rand(n).astype(np.float32),
                np.arange(n) < 48, rng.randint(0, 2, n), None)
    raise ValueError(case)


NMS_CASES = ["random_3072", "groups_512", "chain_half", "all_invalid", "tied_scores"]
