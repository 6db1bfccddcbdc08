"""Command-line entry points of the port (``python -m
repro_torch.launch.serve``, ``.train``, ``.dryrun``) and what the dry run
builds on: the meshes (``mesh``) and the cells' inputs and shardings
(``specs``)."""
