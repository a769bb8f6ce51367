"""Visibility gradients: edge-sampled boundary terms (edges.py)."""
