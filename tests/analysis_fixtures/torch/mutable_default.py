"""Seeded mutable-default violations (exact lines asserted by the test)."""


def bad_list(x, acc=[]):                   # line 4: mutable-default
    acc.append(x)
    return acc


def bad_dict(x, *, seen={}):               # line 9: mutable-default (kw-only)
    seen[x] = True
    return seen


def bad_call(x, order=dict()):             # line 14: mutable-default
    order[x] = 1
    return order


def fine(x, acc=None, n=0, name="q", tags=()):
    return (acc or []) + [x]
