"""Native decode (the pool's `decode` phase) per 1000 spans, in us."""

from benchmark.metrics._common import pool_us_per_kspan


def read(rec):
    return pool_us_per_kspan(rec, "decode")
