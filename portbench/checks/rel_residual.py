"""``rel_residual``: the worst true ‖b − A x‖₂ / ‖b‖₂ over the kept
answers (one a pooled problem, drawn from the seed among its solves in the
window), by the configuration's plain reference in f64."""

import math


def judge(ctx, limit):
    rels = [ctx.reference.rel_residual(x, ctx.domain, ctx.n, fam)
            for x, fam in zip(ctx.answers, ctx.families)]
    worst = max(r if math.isfinite(r) else math.inf for r in rels)
    return worst, sum(not (r <= limit) for r in rels)
