"""The command-line front-end: ``python -m x266_tpu_torch.cli``."""
