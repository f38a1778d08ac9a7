"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` over the window
(reset at its start), GiB, less the bytes of the answers the harness keeps
for the check (one a pooled problem, held by reference throughout the
window): the pool's fields, the route's parts and a solve's work."""


def read(rec):
    if rec.device != "cuda":
        return None
    return rec.peak_bytes / 2**30
