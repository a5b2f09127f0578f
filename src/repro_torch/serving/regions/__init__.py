"""Geo-distributed regions: carbon zones promoted to first-class places.

See :mod:`repro_torch.serving.regions.spec` for the declarative
:class:`RegionSpec` and the :class:`RegionTopology` the fleet executes.
"""

from repro_torch.serving.regions.spec import RegionSpec, RegionTopology

__all__ = ["RegionSpec", "RegionTopology"]
