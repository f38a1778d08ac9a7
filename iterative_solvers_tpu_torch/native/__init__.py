"""Native (C++) engines of the port, loaded with ctypes: CSR assembly
(``assembly.cpp``) and bulk results-file text (``textio.cpp``), compiled at
first use (see :mod:`.loader`); a failed compile raises."""

from iterative_solvers_tpu_torch.native.loader import (
    assemble_csr_native,
    available,
    node_coords_native,
    num_unknowns_native,
)

__all__ = [
    "available",
    "assemble_csr_native",
    "node_coords_native",
    "num_unknowns_native",
]
