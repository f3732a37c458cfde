"""The port's operator tools, run as ``python -m byteps_tpu_torch.tools.<name>``."""
