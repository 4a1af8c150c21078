"""flagd-style feature flags (``flags``) and the flag editor (``flag_ui``)."""

from .flags import FlagEvaluator, FlagFileStore, OfrepClient

__all__ = [
    "FlagEvaluator",
    "FlagFileStore",
    "OfrepClient",
]
