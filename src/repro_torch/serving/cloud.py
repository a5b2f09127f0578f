"""SI4 'End-to-end ML cloud service': registry + spec-served endpoints.

The SageMaker/Vertex analogue, a THIN ADAPTER over the declarative serving
API (:mod:`repro_torch.serving.api`): models live in a registry (persisted
via the TD2 formats), ``deploy`` creates a managed endpoint from a legacy
:class:`~repro_torch.core.add.Deployment`, and ``predict`` / ``predict_multi``
translate those deployments into a :class:`~repro_torch.serving.api.ServingSpec`
and serve them through one :class:`~repro_torch.serving.api.ServingSession` —
same replica fleet, same shared timeline, same energy story, but every
design decision flows through the one spec vocabulary.  New code should
build a ``ServingSpec`` directly; this class is the compatibility shim the
paper-era call sites keep working on.

An endpoint's initial pool is sized by
:meth:`repro_torch.serving.api.AutoscaleSpec.initial_pool` (M/M/c sizing
unless ``replicas_hint`` pins it).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

from repro_torch.configs import get_arch
from repro_torch.core.add import Deployment, ModelFormat, ServingInfrastructure
from repro_torch.core.engines import CompiledEngine, EagerEngine, Engine
from repro_torch.devices import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import formats
from repro_torch.serving.api import (
    ServingSession,
    ServingSpec,
    SpecError,
    endpoint_from_deployment,
)
from repro_torch.serving.fleet import FleetResult
from repro_torch.serving.request import Request, ServingMetrics
from repro_torch.serving.stepcache import StepTimeCache, calibrate


class ModelRegistry:
    """Versioned model store backed by the TD2 serialization formats."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, name: str, version: int) -> str:
        return os.path.join(self.root, f"{name}-v{version}")

    def push(self, name: str, version: int, params, fmt: ModelFormat) -> int:
        path = self._path(name, version)
        if fmt == ModelFormat.NATIVE:
            return formats.save_native(params, path)
        return formats.save_rsm(
            params, path, quantize=(fmt == ModelFormat.RSM_INT8)
        )

    def pull(self, name: str, version: int, template, fmt: ModelFormat,
             as_qtensor: bool = False, device=None):
        path = self._path(name, version)
        if fmt == ModelFormat.NATIVE:
            return formats.load_native(template, path, device=device)
        return formats.load_rsm(template, path, as_qtensor=as_qtensor,
                                device=device)

    def versions(self, name: str) -> List[int]:
        """Stored versions of exactly ``name``.

        Entries are ``<name>-v<int>``; split on the *last* ``-v`` so model
        names that themselves contain ``-v`` (e.g. ``yi-v2``) neither leak
        into other models' listings nor lose their own, and skip suffixes
        that are not integers.
        """
        out = []
        for d in os.listdir(self.root):
            base, sep, suffix = d.rpartition("-v")
            if not sep or base != name:
                continue
            try:
                out.append(int(suffix.split(".")[0]))
            except ValueError:
                continue
        return sorted(set(out))


class CloudService:
    """Managed endpoints on top of the registry (SI4) — a ServingSpec shim.

    Its engines run on ``device``: the GPU unless the caller names the CPU
    (no GPU raises)."""

    def __init__(self, registry_root: str, device=None):
        self.device = resolve_device(device)
        self.registry = ModelRegistry(registry_root)
        self.endpoints: Dict[str, dict] = {}

    def upload_model(self, name: str, version: int, params,
                     fmt: ModelFormat) -> int:
        return self.registry.push(name, version, params, fmt)

    def deploy(self, name: str, version: int, deployment: Deployment,
               template_params=None, seed: int = 0) -> str:
        """Creates a managed endpoint; the user never builds an API (SI4).

        ``template_params`` gives the tree the registry's files load into;
        without it the template is ``init_params(cfg, seed)`` on the
        service's device."""
        deployment.require_valid()
        cfg = get_arch(deployment.arch)
        if template_params is None:
            template_params = init_params(cfg, seed, device=self.device)
        params = self.registry.pull(
            name, version, template_params, deployment.model_format,
            as_qtensor=(deployment.model_format == ModelFormat.RSM_INT8),
            device=self.device,
        )
        # fleet replicas share one engine (same captured graphs) and are
        # simulated as independent scheduler cores in virtual time
        if deployment.si == ServingInfrastructure.SI1_NO_RUNTIME:
            engine: Engine = EagerEngine(cfg, params, deployment.max_seq,
                                         self.device)
        else:
            engine = CompiledEngine(cfg, params, deployment.max_seq,
                                    self.device)
        self.endpoints[name] = {
            "engine": engine,
            "deployment": deployment,
            "warm_cache": None,
            "version": version,
        }
        return f"https://cloud.local/endpoints/{name}"

    def calibrate_endpoint(self, name: str, *, batch_sizes, prompt_len: int,
                           max_new: int) -> StepTimeCache:
        """Measure step times once; every fleet replica is seeded from this
        cache, so large predict() workloads are pure virtual-time replay."""
        ep = self.endpoints[name]
        cache = ep["warm_cache"] or StepTimeCache()
        cfg = get_arch(ep["deployment"].arch)
        calibrate(ep["engine"], cache, batch_sizes=batch_sizes,
                  prompt_len=prompt_len, max_new=max_new,
                  vocab=cfg.vocab_size)
        ep["warm_cache"] = cache
        return cache

    # -- serving (ServingSpec translation) -------------------------------------
    def _spec(self, names, router: Optional[str]) -> ServingSpec:
        deps = {n: self.endpoints[n]["deployment"] for n in names}
        if router is None:
            routers = {d.router for d in deps.values()}
            if len(routers) > 1:
                raise SpecError(
                    "router",
                    f"endpoints disagree on router {sorted(routers)}; "
                    "pass router= explicitly")
            router = next(iter(routers))
        eps = tuple(
            endpoint_from_deployment(n, dep,
                                     version=self.endpoints[n]["version"])
            for n, dep in deps.items()
        )
        return ServingSpec(endpoints=eps, router=router)

    def session(self, names, router: Optional[str] = None) -> ServingSession:
        """A ServingSession over already-deployed endpoints (shared engines
        and warm caches) — the migration path off this shim."""
        session = ServingSession(registry_root=self.registry.root,
                                 device=self.device)
        session.deploy(self._spec(names, router),
                       engines={n: self.endpoints[n]["engine"]
                                for n in names})
        for n in names:
            warm = self.endpoints[n]["warm_cache"]
            if warm is not None:
                session.warm(n, warm)
        return session

    def predict_multi(
        self,
        workloads: Dict[str, List[Request]],
        service_time_hint_s: Union[None, float, Dict[str, float]] = None,
        router: Optional[str] = None,
    ) -> FleetResult:
        """Serve several endpoints on ONE shared virtual timeline.

        A single router places every arrival, and one windowed autoscaler
        re-sizes each endpoint's pool — so energy can be traded across
        endpoints (e.g. ``greenest`` consolidates load fleet-wide).  Request
        ids must be unique across the combined workloads.
        """
        if not workloads:
            raise ValueError("no workloads")
        session = self.session(list(workloads), router)
        for name, wl in workloads.items():
            hint = service_time_hint_s.get(name) \
                if isinstance(service_time_hint_s, dict) \
                else service_time_hint_s
            session.submit(name, wl, service_time_hint_s=hint)
        report = session.run()
        for name in workloads:
            stats = report.result.endpoints[name].fleet or {}
            ep = self.endpoints[name]
            # peak concurrent pool size (the old M/M/c R analogue), NOT the
            # cumulative spawn count — autoscale churn can mint more
            # replicas than ever ran at once
            ep["replicas"] = stats.get("peak_replicas", 0)
            ep["fleet_stats"] = stats
        return report.result

    def predict(self, name: str, workload: List[Request],
                service_time_hint_s: Optional[float] = None,
                router: Optional[str] = None) -> ServingMetrics:
        """Single-endpoint serve (a one-endpoint fleet on its own timeline)."""
        result = self.predict_multi({name: workload},
                                    service_time_hint_s=service_time_hint_s,
                                    router=router)
        return result.endpoints[name]
