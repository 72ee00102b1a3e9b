"""Scenario-matrix engine over the survey's taxonomy (the port's counterpart
of ``repro.experiments``): :mod:`.scenario` (the frozen ``Scenario`` point,
``grid`` / ``expand``), :mod:`.runner` (the timeline, training and schedule
substrates with cost-model predictions), :mod:`.tables` and the CLI
``python -m repro_torch.experiments.run``."""

from repro_torch.experiments.scenario import Scenario, expand, grid  # noqa: F401
