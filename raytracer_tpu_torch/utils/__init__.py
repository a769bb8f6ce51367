"""Checkpoints, render statistics and console logging."""
