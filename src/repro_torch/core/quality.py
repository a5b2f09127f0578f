"""The eight quality characteristics the paper catalogues (ISO 25010 +
'greenability' [Calero & Piattini 2015]), and a structured report type.

Each entry records HOW the value was obtained — ``measured`` (wall-clock /
bytes on this host), ``derived`` (analytical, e.g. roofline energy on the
target card), or ``qualitative`` (the paper's own survey-level assessment) —
so the green report never silently mixes provenance.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional


class Quality(enum.Enum):
    ENERGY_EFFICIENCY = "energy_efficiency"
    PERFORMANCE_EFFICIENCY = "performance_efficiency"
    MAINTAINABILITY = "maintainability"
    ANALYSABILITY = "analysability"
    USABILITY = "usability"
    SCALABILITY = "scalability"
    PORTABILITY = "portability"
    INTEROPERABILITY = "interoperability"


class Provenance(enum.Enum):
    MEASURED = "measured"
    DERIVED = "derived"
    QUALITATIVE = "qualitative"


@dataclasses.dataclass
class QualityValue:
    value: float                      # metric value or 1-5 qualitative score
    unit: str
    provenance: Provenance
    note: str = ""


@dataclasses.dataclass
class QualityReport:
    subject: str                      # deployment description
    entries: Dict[Quality, QualityValue] = dataclasses.field(default_factory=dict)

    def add(self, q: Quality, value: float, unit: str, prov: Provenance,
            note: str = ""):
        self.entries[q] = QualityValue(value, unit, prov, note)

    def get(self, q: Quality) -> Optional[QualityValue]:
        return self.entries.get(q)

    def table(self) -> str:
        rows = [f"# quality report: {self.subject}",
                f"{'characteristic':<26}{'value':>14}  {'unit':<12}"
                f"{'provenance':<12}note"]
        for q in Quality:
            e = self.entries.get(q)
            if e is None:
                continue
            rows.append(
                f"{q.value:<26}{e.value:>14.6g}  {e.unit:<12}"
                f"{e.provenance.value:<12}{e.note}"
            )
        return "\n".join(rows)
