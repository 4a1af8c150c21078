"""Mean wait of a batch for its device put on the spine, in ms."""

from benchmark.metrics._common import phase_mean_ms


def read(rec):
    return phase_mean_ms(rec, "put_wait")
