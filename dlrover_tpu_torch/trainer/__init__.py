"""Training: the single-device train step (``train_lib``)."""
