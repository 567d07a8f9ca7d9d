"""Runnable demos of the port (python -m rt_tpu_torch.examples.<name>)."""
