"""Runnable examples of the port (``python -m dlrover_tpu_torch.examples.<name>``)."""
