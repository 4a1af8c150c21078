"""Share of the traced slice in which no device operation ran, in %."""

from benchmark.metrics._common import idle_pct


def read(rec):
    return idle_pct(rec)
