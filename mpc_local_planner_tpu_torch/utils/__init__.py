"""Host-side helpers (port of ``mpc_local_planner_tpu.utils``)."""
