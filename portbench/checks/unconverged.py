"""``unconverged``: the window's solves that the program reported as not
converged."""


def judge(ctx, limit):
    bad = sum(not s["converged"] for s in ctx.solves)
    return bad, bad if bad > limit else 0
