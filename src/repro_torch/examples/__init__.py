"""Runnable examples of the port (``python -m repro_torch.examples.<name>``):
``quickstart``, ``derived_operators``, ``homomorphic_analytics`` and
``serve_batched``.  Each takes ``--device`` (default ``cuda``)."""
