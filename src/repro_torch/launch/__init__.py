"""Launchers: the device meshes (``mesh``), the token-serving launcher
(``python -m repro_torch.launch.serve``) and the training launcher
(``python -m repro_torch.launch.train``)."""
