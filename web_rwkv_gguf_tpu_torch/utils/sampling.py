"""Token samplers on the host (app-level, as in the reference's examples).

They take probabilities as numpy (``runtime.softmax`` of an Engine's
logits) and draw with numpy's ``default_rng(seed)``, so one seed draws
the same tokens in every package; ``models.generate.make_sampler`` is the
sampler on the device. Nucleus sampling follows
examples/chat.rs:158-194: sort descending, keep tokens until the
cumulative probability exceeds ``top_p`` (inclusive of the crossing
token), apply ``p**(1/temp)``, renormalize, then draw.
"""

from __future__ import annotations

import numpy as np


class GreedySampler:
    def sample(self, probs: np.ndarray, rng: np.random.Generator | None = None) -> int:
        return int(np.asarray(probs).argmax())


class NucleusSampler:
    def __init__(self, top_p: float = 0.5, temp: float = 1.0, seed: int | None = None):
        self.top_p = float(top_p)
        self.temp = float(temp)
        self.rng = np.random.default_rng(seed)

    def sample(self, probs: np.ndarray, rng: np.random.Generator | None = None) -> int:
        rng = rng or self.rng
        p = np.asarray(probs, np.float64)
        order = np.argsort(-p, kind="stable")
        sorted_p = p[order]
        cum = np.cumsum(sorted_p)
        # keep every token whose *preceding* cumulative sum is <= top_p
        prev = np.concatenate([[0.0], cum[:-1]])
        keep = prev <= self.top_p
        idx = order[keep]
        kept = sorted_p[keep] ** (1.0 / self.temp)
        kept /= kept.sum()
        draw = rng.random()
        cum = np.cumsum(kept)
        pos = int(np.searchsorted(cum, draw, side="left"))
        pos = min(pos, len(idx) - 1)
        return int(idx[pos])


class TypicalSampler:
    """Locally-typical sampling (tau = mass to keep), with temperature."""

    def __init__(self, tau: float = 0.5, temp: float = 1.0, seed: int | None = None):
        self.tau = float(tau)
        self.temp = float(temp)
        self.rng = np.random.default_rng(seed)

    def sample(self, probs: np.ndarray, rng: np.random.Generator | None = None) -> int:
        rng = rng or self.rng
        p = np.asarray(probs, np.float64)
        p = p / p.sum()
        logp = np.log(np.maximum(p, 1e-30))
        entropy = -(p * logp).sum()
        deviation = np.abs(-logp - entropy)
        order = np.argsort(deviation, kind="stable")
        sorted_p = p[order]
        cum = np.cumsum(sorted_p)
        prev = np.concatenate([[0.0], cum[:-1]])
        keep = prev <= self.tau
        idx = order[keep]
        kept = sorted_p[keep] ** (1.0 / self.temp)
        kept /= kept.sum()
        pos = int(np.searchsorted(np.cumsum(kept), rng.random(), side="left"))
        pos = min(pos, len(idx) - 1)
        return int(idx[pos])
