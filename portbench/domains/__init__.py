"""Domain predicates, one file a domain kind (a configuration's
``domain.kind``): ``AXES`` (the field's axes, slowest first) and
``interior(n, idx)``, the unknowns among the nodes of index tensors
``idx`` on a grid of ``n`` intervals a side. Read by the plain reference;
nothing of the program."""
