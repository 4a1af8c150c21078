"""Mean host time of one dispatch (the step enqueued), in ms."""

from benchmark.metrics._common import phase_mean_ms


def read(rec):
    return phase_mean_ms(rec, "dispatch")
