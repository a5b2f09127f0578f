"""simlint: static invariant analysis for the green-serving simulator.

The port's copy of the JAX package's ``analysis`` package, with the same
rules and findings, scoped to the port's files: the simulator layers
``src/repro_torch/{serving,carbon,workload,energy}``, and as drivers
``chip_smoke.py`` and ``scripts/torch_*.py``.  R2 also knows torch's
module-global generator.

Every design-decision comparison this repo produces is only as credible as
the simulator's accounting, and three of its contracts are invisible to the
test suite until they break at a distance:

  * **billing** — all wall x power arithmetic flows through the one
    :class:`repro_torch.energy.meter.EnergyMeter` (R1 ``billed-time``);
  * **determinism** — the virtual timeline depends only on workload + seed,
    never on wall-clock reads, unseeded randomness, set iteration order, or
    ``id()``-keyed containers (R2 ``wall-clock`` / ``unseeded-random`` /
    ``set-iteration`` / ``id-key``);
  * **causality** — the virtual clock advances only through
    ``SchedulerCore``'s event API, and every billing event carries the
    virtual instant it was drawn at (R4 ``clock-causality``);
  * **spec completeness** — every declarative spec field round-trips through
    ``to_json``/``from_json`` and is validated and sweepable (R3
    ``spec-roundtrip``), checked statically against ``ServingSpec.from_dict``.

``python -m repro_torch.analysis --strict`` runs the whole catalog over
``src/repro_torch`` (simulator rules), ``chip_smoke.py`` and
``scripts/torch_*.py`` (driver rules) using nothing but the stdlib ``ast``
module — no model imports, no third-party dependencies.

Legitimate measurement sites (step-time calibration, codec timing) are
annotated in-line with ``# simlint: allow(<rule>)``; the contracts
themselves are documented in ``docs/INVARIANTS.md``.
"""

from repro_torch.analysis.engine import lint_paths, lint_source  # noqa: F401
from repro_torch.analysis.findings import Finding  # noqa: F401
from repro_torch.analysis.rules import RULE_IDS  # noqa: F401
