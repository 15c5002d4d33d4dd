"""Runnable examples of the port (``python -m repro_torch.examples.<name>``):
``quickstart``, ``derived_operators``, ``homomorphic_analytics``,
``serve_batched`` and ``train_lm_compressed_dp``.  Each takes ``--device``
(default ``cuda``)."""
