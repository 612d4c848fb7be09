"""The port's command line: ``python -m mallorn_tpu_torch.cli.main``."""
