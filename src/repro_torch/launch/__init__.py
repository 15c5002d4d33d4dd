"""Launchers: the analytics device mesh (``mesh``) and the token-serving
launcher (``python -m repro_torch.launch.serve``)."""
