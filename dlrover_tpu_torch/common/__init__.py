"""Helpers shared across the port's planes."""
