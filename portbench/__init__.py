"""The benchmark of the PyTorch and CUDA port (``iterative_solvers_tpu_torch``).

Run one cell of ``BENCHMARK.json`` on the card::

    python -m portbench.run --workload gamma2d.mg_8192 --seed 7 --seconds 30 --trace 0

Everything that belongs to one configuration, cell, window entry or
metric lives in a file of its own, found by name:

- ``configs/<config>.json``: the deployment (source, domain, stencil,
  guarantee) and the names of its domain kind, problem family and reference;
- ``domains/<kind>.py``: which nodes are unknowns;
- ``families/<family>.py``: the manufactured u and f = Δu of a parameter α;
- ``reference/<reference>.py``: the plain f64 reference that judges answers;
- ``workloads/<cell>.json``: the cell's traffic (size, right-hand-side
  pool, α range, stop, route, what the route must build) and one limit a
  check;
- ``checks/<check>.py``: one number that decides ``correct``;
- ``routes/<route>.py``: builds the port's parts and returns the solve call;
- ``metrics/<metric>.py``: reads one metric from a run's record.

The yardstick (``problems.py``, ``yardstick.py``, ``domains/``,
``families/``, ``reference/``, ``checks/``) never imports the port, so a
change to the program cannot move it.
"""
