"""Measurement scripts of the port's kernels, run on a machine with a card."""
