"""Mean host time of one report harvest (wait and copy), in ms."""

from benchmark.metrics._common import phase_mean_ms


def read(rec):
    return phase_mean_ms(rec, "harvest")
