"""Training and several ranks: loss and gradients of the scene parameters
(sharding.py), the process group, mesh and collectives (distributed.py),
and one rank of a run (worker.py)."""
