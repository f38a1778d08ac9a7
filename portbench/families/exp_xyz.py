"""u_α = exp(α·xyz), f_α = Δu_α = α²((yz)² + (xz)² + (xy)²)·u_α."""

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Family:
    alpha: float

    def u(self, x, y, z):
        return torch.exp(self.alpha * x * y * z)

    def f(self, x, y, z):
        return self.alpha**2 * ((y * z) ** 2 + (x * z) ** 2 + (x * y) ** 2) * self.u(x, y, z)
