"""Command-line examples of the port, each run as
``python -m torchoptics_tpu_torch.examples.<name>``."""
