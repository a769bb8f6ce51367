"""Training: loss and gradients of the scene parameters (sharding.py)."""
