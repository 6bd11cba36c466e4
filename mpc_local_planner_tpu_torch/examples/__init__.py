"""Demos of the PyTorch port (counterparts of the repository's ``examples/``).

Each runs as ``python -m mpc_local_planner_tpu_torch.examples.<demo>`` on
CUDA unless ``--device cpu`` is passed.
"""
