"""Host streaming runtime: OTLP decode, span → batch tensorization, and
the pipeline that feeds the detector on the device and harvests its
reports without stalling dispatch."""

from .tensorize import SpanRecord, SpanTensorizer, TensorBatch

__all__ = ["SpanRecord", "SpanTensorizer", "TensorBatch"]
