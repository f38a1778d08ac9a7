"""u_α = exp(α(x² − y²)), f_α = Δu_α = 4α²(x² + y²)·u_α (α = 1 is the
upstream's problem)."""

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Family:
    alpha: float

    def u(self, x, y):
        return torch.exp(self.alpha * (x * x - y * y))

    def f(self, x, y):
        return 4.0 * self.alpha**2 * (x * x + y * y) * self.u(x, y)
