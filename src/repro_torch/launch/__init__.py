"""Launchers: the device meshes and the logical sharding rules (``mesh``),
the dry run of every (arch x shape x mesh) cell on ``meta`` tensors
(``python -m repro_torch.launch.dryrun``) with its op counter
(``op_analysis``) and roofline (``python -m repro_torch.launch.roofline``),
the token-serving launcher (``python -m repro_torch.launch.serve``) and the
training launcher (``python -m repro_torch.launch.train``)."""
