"""Numerical building blocks (port of ``mpc_local_planner_tpu.numerics``)."""
