"""The numbers that decide ``correct``, one file each, named by the keys of
a cell's ``limits``: ``judge(ctx, limit) -> (value, failed)``, where
``ctx`` has ``answers`` (the kept answer of each pooled problem),
``families`` (the pool), ``solves`` (the window's records), ``reference``
(the configuration's plain reference), ``domain`` and ``n`` (the grid),
and ``failed`` counts the answers or solves that broke the limit."""
