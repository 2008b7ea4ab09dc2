"""Runnable examples of the port; each is ``python -m pytorch_toolbelt_tpu_torch.examples.<name>``."""
