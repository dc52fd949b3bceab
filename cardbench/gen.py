"""Traffic generators, driven by a traffic file's parameters and the seed.

The same seed gives the same inputs. Every seed gets the same set of sizes
and gaps, in another order, so seeds change which image comes when and not
how much work a run holds."""
import itertools
from typing import List, Sequence

import numpy as np
import torch

from cardbench.weights import sub_seed


def image_pool(n: int, hwc: Sequence[int], seed: int,
               device: torch.device) -> np.ndarray:
    """``n`` distinct uint8 images (n, H, W, C), drawn on ``device`` and
    returned as one host array."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "images"))
    x = torch.randint(0, 256, (n, *hwc), generator=gen, device=device,
                      dtype=torch.uint8)
    return x.cpu().numpy()


def labels(n: int, classes: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(sub_seed(seed, "labels"))
    return rng.integers(0, classes, n).astype(np.int32)


def order(n: int, seed: int, purpose: str) -> np.ndarray:
    """A seeded permutation of ``range(n)``."""
    return np.random.default_rng(sub_seed(seed, purpose)).permutation(n)


def arrivals(phases: List[Sequence[float]], seconds: float,
             seed: int) -> np.ndarray:
    """Due times (s from the window's start) of an open loop over
    ``seconds``. ``phases`` is a cycle of ``[length_s, rate_per_s]``: in
    each phase the gaps are the exponential distribution's quantiles at
    ``(i + 0.5) / n`` for its ``n = round(length * rate)`` arrivals, in a
    seeded order, so every seed sends the same gaps."""
    out, start, k = [], 0.0, 0
    cycle_len = sum(p[0] for p in phases)
    if cycle_len <= 0:
        raise ValueError("traffic phases must have a positive length")
    while start < seconds:
        length, rate = phases[k % len(phases)]
        n = int(round(length * rate))
        if n > 0:
            q = (np.arange(n) + 0.5) / n
            gaps = -np.log1p(-q) / rate
            gaps = gaps[order(n, seed, f"gaps/{k}")]
            # the phase's gaps sum to its length: scale away the rounding
            gaps *= length / gaps.sum()
            t = start + np.cumsum(gaps) - gaps[0] * 0.5
            out.append(t[t < min(seconds, start + length)])
        start += length
        k += 1
    return np.concatenate(out) if out else np.zeros(0)


def pool_stream(pool: int, seed: int):
    """Pool indices without end: whole seeded permutations of the pool,
    one after another."""
    for rep in itertools.count():
        yield from order(pool, seed, f"pool/{rep}").tolist()


def pool_sequence(count: int, pool: int, seed: int) -> np.ndarray:
    """Which pool image each of ``count`` requests carries: the first
    ``count`` of :func:`pool_stream`."""
    return np.fromiter(itertools.islice(pool_stream(pool, seed), count),
                       np.int64, count)
