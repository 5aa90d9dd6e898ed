"""Host-side utilities of the PyTorch port: the JAX package's ``utils``
modules that the engine needs (tracing, KV stores, metrics, profiling, the
flight recorder, request spans, the health monitor), copied with their
imports pointed at this package. ``tests/test_torch_copies.py`` holds each
copy equal to its original."""
