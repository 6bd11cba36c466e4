"""Plants: simulation targets for closed-loop control (port of
``mpc_local_planner_tpu.plants``; parity: cbr:plants — simulated_plant.h)."""

from mpc_local_planner_tpu_torch.plants.simulated_plant import PlantState, SimulatedPlant

__all__ = ["SimulatedPlant", "PlantState"]
