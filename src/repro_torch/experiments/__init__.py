"""Scenario-matrix engine over the survey's taxonomy (the port's counterpart
of ``repro.experiments``): :mod:`.scenario` (the frozen ``Scenario`` point,
``grid`` / ``expand``), :mod:`.runner` (the timeline, training, schedule,
roofline and trainer substrates with cost-model predictions),
:mod:`.trainer_substrate` (cells through the real trainer), :mod:`.tables`
and the CLI ``python -m repro_torch.experiments.run``.

The runner's and the tables' names resolve at first use (PEP 562), as in
the reference, so that importing the package for ``Scenario`` does not load
the engine."""

from repro_torch.experiments.scenario import Scenario, expand, grid  # noqa: F401

_LAZY = {
    "ScenarioResult": "repro_torch.experiments.runner",
    "estimated_wire_bytes": "repro_torch.experiments.runner",
    "measure_engine_speedup": "repro_torch.experiments.runner",
    "measure_sweep_speedup": "repro_torch.experiments.runner",
    "roofline_row": "repro_torch.experiments.runner",
    "rounds_per_iter": "repro_torch.experiments.runner",
    "run_scenario": "repro_torch.experiments.runner",
    "run_scenarios": "repro_torch.experiments.runner",
    "sweep_matrix_45": "repro_torch.experiments.runner",
    "training_shape_key": "repro_torch.experiments.runner",
    "format_table": "repro_torch.experiments.tables",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
