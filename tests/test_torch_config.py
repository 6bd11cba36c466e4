"""The config tree: the port's ``planner/config.py`` against the JAX package's.

Every ``examples/cfg/*.yaml`` gives equal namespaces, an equal ``OcpSpec``
(the model and footprint by type and parameters) and equal cold, warm and
rescue ``SolverSettings``, also under the solver options that change the
presets (``lsq_lm``, ``early_exit``, ``max_cycle_ms``, explicit budgets);
``reconfigure_config`` merges reference-style nested updates the same way;
unknown namespaces and keys and bad modes raise the same errors with the
same messages. The Controller phases of ``chip_smoke.py`` build their
configs from dict literals (the card's machine has no YAML reader): the
single-robot literal loads to the same ``PlannerConfig`` as
``examples/cfg/carlike_minimum_time.yaml``.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from mpc_local_planner_tpu.planner import config as j_config

from mpc_local_planner_tpu_torch.planner import config as t_config

ROOT = Path(__file__).resolve().parent.parent
YAMLS = sorted((ROOT / "examples" / "cfg").glob("*.yaml"))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_object(t_obj, j_obj):
    """Same class name and the same field values (arrays compared as numbers)."""
    assert type(t_obj).__name__ == type(j_obj).__name__
    for f in dataclasses.fields(j_obj):
        jv, tv = getattr(j_obj, f.name), getattr(t_obj, f.name)
        np.testing.assert_array_equal(np.asarray(tv, dtype=float), np.asarray(jv, dtype=float))


def assert_same_spec(t_spec, j_spec):
    for f in dataclasses.fields(j_spec):
        jv, tv = getattr(j_spec, f.name), getattr(t_spec, f.name)
        if f.name in ("model", "footprint"):
            _same_object(tv, jv)
        elif f.name == "limits":
            assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
        else:
            assert tv == jv, f.name


def assert_same_config(t_cfg, j_cfg):
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    t_spec, j_spec = t_cfg.to_ocp_spec(), j_cfg.to_ocp_spec()
    assert_same_spec(t_spec, j_spec)
    cold = t_cfg.solver_settings(t_spec)
    assert dataclasses.asdict(cold) == dataclasses.asdict(j_cfg.solver_settings(j_spec))
    warm = t_cfg.warm_solver_settings(t_spec)
    assert dataclasses.asdict(warm) == dataclasses.asdict(j_cfg.warm_solver_settings(j_spec))
    for t_base, j_base in ((cold, j_cfg.solver_settings(j_spec)),
                           (warm, j_cfg.warm_solver_settings(j_spec))):
        assert (dataclasses.asdict(t_cfg.solver.rescue_settings(t_base))
                == dataclasses.asdict(j_cfg.solver.rescue_settings(j_base)))


@pytest.mark.parametrize("path", YAMLS, ids=[p.stem for p in YAMLS])
def test_torch_example_yaml_gives_the_same_spec_and_settings(path):
    assert_same_config(t_config.load_config(str(path)), j_config.load_config(str(path)))
    # the YAML text itself, and the file read as a dict, load the same way
    text = path.read_text()
    assert_same_config(t_config.load_config(text), j_config.load_config(text))


SOLVER_VARIANTS = [
    {"type": "lsq_lm"},
    {"type": "lsq_lm", "rho0": 50.0, "warm_iterations": 3, "warm_inner_iterations": 6},
    {"early_exit": True, "iterations": 5, "inner_iterations": 6, "rho0": 20.0},
    {"max_cycle_ms": 40.0, "rescue_slots": 64, "rescue_iterations": 3},
    {"rho_growth": 7.0, "tol_eq": 0.01, "polish_launches": 2, "f64_fallback_slots": 8},
]


@pytest.mark.parametrize("solver", SOLVER_VARIANTS)
@pytest.mark.parametrize("name", ["carlike_minimum_time", "diff_drive_quadratic_form"])
def test_torch_solver_options_give_the_same_presets(name, solver):
    path = ROOT / "examples" / "cfg" / f"{name}.yaml"
    updates = {"solver": solver}
    assert_same_config(
        t_config.reconfigure_config(t_config.load_config(str(path)), updates),
        j_config.reconfigure_config(j_config.load_config(str(path)), updates),
    )


RECONFIGURE_UPDATES = [
    {"planning": {"objective": {"type": "quadratic_form",
                                "quadratic_form": {"state_weights": [3.0, 3.0, 1.0],
                                                   "control_weights": [0.5, 0.5]}},
                  "terminal_cost": {"type": "quadratic",
                                    "quadratic": {"final_state_weights": [5.0, 5.0, 1.0]}}}},
    {"grid": {"grid_size_ref": 24, "variable_grid": {
        "grid_adaptation": {"enable": True, "max_grid_size": 40, "min_grid_size": 10}}}},
    {"robot": {"type": "unicycle", "unicycle": {"max_vel_x": 0.6, "max_vel_theta": 0.9}}},
    {"collision": {"costmap_converter": "lines", "line_capacity": 4}, "via_capacity": 3},
    {"footprint_model": {"type": "polygon",
                         "vertices": [[0.2, 0.1], [-0.2, 0.1], [-0.2, -0.1], [0.2, -0.1]]},
     "planning": {"terminal_constraint": {"type": "ball", "ball": {"radius": 0.3}}}},
    {"footprint_model": {"type": "line", "line_start": [-0.25, 0.0], "line_end": [0.3, 0.0]},
     "grid": {"type": "non_uniform_fd_grid", "collocation_method": "midpoint_differences"}},
]


@pytest.mark.parametrize("updates", RECONFIGURE_UPDATES)
def test_torch_reconfigure_config_merges_like_jax(updates):
    path = str(ROOT / "examples" / "cfg" / "carlike_minimum_time.yaml")
    t_cfg = t_config.reconfigure_config(t_config.load_config(path), updates)
    j_cfg = j_config.reconfigure_config(j_config.load_config(path), updates)
    assert_same_config(t_cfg, j_cfg)


BAD = [
    ("load", {"solverz": {}}, None),  # unknown top-level keys are ignored by load_config
    ("load", {"solver": {"iterationz": 3}}, KeyError),
    ("load", {"grid": {"variable_grid": {"grid_adaptation": {"speed": 1}}}}, KeyError),
    ("load", {"grid": {"type": "hex_grid"}}, ValueError),
    ("load", {"grid": {"variable_grid": {"grid_adaptation": {"mode": "sometimes"}}}},
     ValueError),
    ("load", {"collision": {"costmap_converter": "voxels"}}, ValueError),
    ("load", {"robot": {"type": "hovercraft"}}, ValueError),
    ("load", {"footprint_model": {"type": "blob"}}, ValueError),
    ("reconfigure", {"sensors": {"x": 1}}, KeyError),
    ("reconfigure", {"controller": {"xy_goal_tol": 0.1}}, KeyError),
    ("reconfigure", {"grid": {"grid_adaptation_mode": "never"}}, ValueError),
]


@pytest.mark.parametrize("how, source, err", BAD)
def test_torch_config_refuses_what_jax_refuses(how, source, err):
    def run(mod):
        if how == "load":
            cfg = mod.load_config(source)
        else:
            cfg = mod.reconfigure_config(mod.load_config({}), source)
        cfg.to_ocp_spec()  # the model and footprint factories raise here
        return cfg

    if err is None:
        assert_same_config(run(t_config), run(j_config))
        return
    with pytest.raises(err) as j_err:
        run(j_config)
    with pytest.raises(err) as t_err:
        run(t_config)
    assert str(t_err.value) == str(j_err.value)


def test_torch_chip_smoke_config_literals_load_like_the_example_and_the_demo():
    smoke = _smoke()
    yaml_path = str(ROOT / "examples" / "cfg" / "carlike_minimum_time.yaml")
    literal = t_config.load_config(smoke.CARLIKE_MINIMUM_TIME)
    assert literal == t_config.load_config(yaml_path)
    assert_same_config(literal, j_config.load_config(yaml_path))
    spec = literal.to_ocp_spec()
    assert (spec.N, spec.obstacle_cap, type(spec.footprint).__name__) == (
        50, 30, "TwoCirclesFootprint")
    # the fleet literal: examples/demo_fleet.py's dict at 4096 robots
    fleet = t_config.load_config(smoke.FLEET_CONFIG)
    assert_same_config(fleet, j_config.load_config(smoke.FLEET_CONFIG))
    fspec = fleet.to_ocp_spec()
    assert (fspec.N, fspec.obstacle_cap, fleet.solver.rescue_slots) == (30, 8, 1024)
    assert (type(fspec.model).__name__, type(fspec.footprint).__name__,
            fspec.footprint.radius, fspec.objective) == (
        "SimpleCarModel", "CircularFootprint", 0.2, "minimum_time")


def test_torch_chip_smoke_shell_literal_loads_like_the_example():
    """The planner shell phase's dict is examples/cfg/diff_drive_quadratic_form.yaml
    written out (examples/demo_planner.py's default config)."""
    smoke = _smoke()
    yaml_path = str(ROOT / "examples" / "cfg" / "diff_drive_quadratic_form.yaml")
    literal = t_config.load_config(smoke.DIFF_DRIVE_QUADRATIC_FORM)
    assert literal == t_config.load_config(yaml_path)
    assert_same_config(literal, j_config.load_config(yaml_path))
    spec = literal.to_ocp_spec()
    assert (spec.N, spec.obstacle_cap, type(spec.model).__name__, spec.objective) == (
        20, 30, "UnicycleModel", "quadratic_form")
