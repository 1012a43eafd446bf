"""Entry points of the port that a user runs: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train`` and ``python -m repro_torch.launch.dryrun``;
the meshes they build (`mesh`) and the dry-run's abstract inputs (`specs`)."""
