"""Manufactured problem families, one file each (a configuration's
``family``): ``Family(alpha)`` with ``u`` and ``f`` = Δu, taking and giving
torch tensors of the node coordinates (x, y[, z])."""
