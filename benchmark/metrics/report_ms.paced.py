"""Mean host time of the pipeline's ``on_report`` callback (the daemon's
metric export, remediation observe and lag gauge: ``report``), in ms."""

from benchmark.metrics._common import phase_mean_ms


def read(rec):
    return phase_mean_ms(rec, "report")
