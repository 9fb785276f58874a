"""Suppression mechanics fixture (exact lines asserted by the test)."""


def tolerated(tbl):
    return tbl.cpus.sum().item()  # analysis: ignore[host-read] -- fixture: valid suppression


def unused_suppression(tbl):
    return tbl.cpus + 1  # analysis: ignore[host-read] -- nothing to suppress here


def missing_reason(tbl):
    return tbl.cpus.sum().item()  # analysis: ignore[host-read]


def unknown_rule(tbl):
    return tbl.cpus  # analysis: ignore[tracer-leak] -- the reference's rule, not the port's
