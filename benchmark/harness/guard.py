"""What a run must not load: JAX, its libraries, or the JAX package the
port was made from. Top-level module names are compared whole (the
port's own name begins with the JAX package's)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "opentelemetry_demo_tpu")


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names if m.split(".")[0] in FORBIDDEN})
