"""Host batching pipeline: numpy copies of ``repro.data`` modules."""
