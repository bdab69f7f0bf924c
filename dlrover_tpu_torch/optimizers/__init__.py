"""Optimizers: hand ports of the optax transformations the trainer uses."""
