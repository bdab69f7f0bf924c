"""Runtime helpers: device resolution."""

from dlrover_tpu_torch.runtime.device import resolve_device  # noqa: F401
