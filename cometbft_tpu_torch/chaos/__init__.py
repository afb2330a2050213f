"""Deterministic chaos harness: seeded network fault plane + nemesis
scheduler + BFT invariant checkers.

A copy of the JAX package's ``chaos/``, with the same ``__all__``. The
nets run on a device: ``run_schedule``, ``ChaosNet``, ``run_scenario``,
``run_matrix``, ``run_soak`` and ``storm_for_chaos`` take ``device``
(None is the GPU, and raises without one; ``device="cpu"`` the host
plane or the plain kernels) and hand it to every node, every scheduler
ticket and every light plane they build. A failed verify route is a
``DeviceRouteError``, never a verdict.

Quick start (see docs/CHAOS.md for the full story)::

    from cometbft_tpu_torch.chaos import default_schedule, run_schedule
    report = await run_schedule(default_schedule(), seed=1337,
                                base_dir=tmpdir, device="cpu")
    assert report.ok, report.format()

CLI: ``python -m cometbft_tpu_torch.chaos --seed 1337 [--device cpu]``;
scenario factory: ``python -m cometbft_tpu_torch.chaos matrix --seed 1337
--count 5`` (docs/CHAOS.md "Scenario factory").
"""

from .generator import (
    LIFECYCLES,
    ScenarioSpec,
    generate_matrix,
    generate_scenario,
)
from .invariants import (
    AgreementChecker,
    InvariantViolation,
    WALReplayChecker,
)
from .links import ChaosConnection, LinkState, LinkTable
from .matrix import MatrixReport, run_matrix, run_scenario
from .nemesis import Nemesis
from .net import ChaosNet, ChaosReport, run_schedule
from .schedule import FaultEvent, FaultSchedule, default_schedule
from .workload import WorkloadDriver, WorkloadSpec

__all__ = [
    "AgreementChecker",
    "ChaosConnection",
    "ChaosNet",
    "ChaosReport",
    "FaultEvent",
    "FaultSchedule",
    "InvariantViolation",
    "LIFECYCLES",
    "LinkState",
    "LinkTable",
    "MatrixReport",
    "Nemesis",
    "ScenarioSpec",
    "WALReplayChecker",
    "WorkloadDriver",
    "WorkloadSpec",
    "default_schedule",
    "generate_matrix",
    "generate_scenario",
    "run_matrix",
    "run_scenario",
    "run_schedule",
]
