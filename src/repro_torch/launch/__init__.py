"""Command-line entry points of the port (``python -m repro_torch.launch.tsne_run``,
``serve``, ``train``, ``dryrun``) and the dry-run's mesh, cell and cost
report."""
