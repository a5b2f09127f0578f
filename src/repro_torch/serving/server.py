"""SI3 'DL-specific software': a packaged model server.

The TF-Serving/TorchServe/Triton analogue: models are *packaged* (manifest +
handler), the server owns the API (no hand-built web layer), configures an
endpoint per model, applies the TD3 batching policy, and speaks the TD4 wire
codec.  Contrast with SI1/SI2 where the practitioner wires the engine to a
web framework manually.

Since the spec redesign this class is a THIN ADAPTER: ``handle`` translates
the server's :class:`~repro_torch.core.add.Deployment` into a single-endpoint
:class:`~repro_torch.serving.api.ServingSpec` (fixed one-replica pool, no
autoscaling — the SI3 shape) and serves it through a
:class:`~repro_torch.serving.api.ServingSession`.  New code should build a spec
directly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

from repro_torch.configs import get_arch
from repro_torch.core.add import Deployment, ServingInfrastructure
from repro_torch.core.engines import CompiledEngine, EagerEngine, Engine
from repro_torch.devices import resolve_device
from repro_torch.serving.api import (
    ServingSession,
    ServingSpec,
    endpoint_from_deployment,
)
from repro_torch.serving.codecs import make_codec
from repro_torch.serving.request import Request, ServingMetrics


@dataclasses.dataclass
class ModelPackage:
    """What a practitioner hands to the DL-serving software."""

    name: str
    arch: str
    params: object                    # parameter tree (torch tensors)
    version: int = 1
    handler: str = "lm_generate"      # packaged pre/post-processing
    max_seq: int = 256


@dataclasses.dataclass
class CodecStats:
    request_bytes: int = 0
    response_bytes: int = 0
    encode_s: float = 0.0
    decode_s: float = 0.0


class ServingServer:
    """One server process hosting N packaged models (SI3), on ``device``:
    the GPU unless the caller names the CPU (no GPU raises)."""

    def __init__(self, deployment: Deployment, device=None):
        deployment.require_valid()
        self.device = resolve_device(device)
        self.deployment = deployment
        self.codec = make_codec(deployment.protocol.value)
        self.endpoints: Dict[str, Tuple[Engine, ModelPackage]] = {}
        self._step_caches: Dict[str, object] = {}

    # -- packaging / endpoint configuration (the SI3 'no manual API' step) ----
    def register(self, pkg: ModelPackage, step_cache=None) -> str:
        """Configure an endpoint; an optional StepTimeCache makes repeated
        workloads replay measured step times instead of re-executing."""
        cfg = get_arch(pkg.arch)
        dep = self.deployment
        if dep.si == ServingInfrastructure.SI1_NO_RUNTIME:
            engine: Engine = EagerEngine(cfg, pkg.params, pkg.max_seq, self.device)
        else:
            engine = CompiledEngine(cfg, pkg.params, pkg.max_seq, self.device)
        self.endpoints[pkg.name] = (engine, pkg)
        if step_cache is not None:
            self._step_caches[pkg.name] = step_cache
        return f"/v1/models/{pkg.name}:predict"

    def warmup(self, name: str, batch: int, prompt_len: int) -> float:
        engine, _ = self.endpoints[name]
        return engine.warmup(batch, prompt_len)

    # -- the Deployment -> ServingSpec translation ----------------------------
    def _session(self, name: str) -> ServingSession:
        """One-endpoint session: the SI3 server is a fixed single replica
        (no cloud autoscaling), optionally replaying a registered cache."""
        engine, pkg = self.endpoints[name]
        cache = self._step_caches.get(name)
        ep = dataclasses.replace(
            endpoint_from_deployment(name, self.deployment,
                                     max_seq=pkg.max_seq,
                                     autoscale_enabled=False),
            arch=pkg.arch,
            version=pkg.version,
            step_cache=cache is not None,
        )
        # pin the pool at exactly one replica: an SI3 server process is one
        # scheduler, whatever the deployment's cloud knobs say
        ep = dataclasses.replace(
            ep, autoscale=dataclasses.replace(ep.autoscale, replicas_hint=1))
        session = ServingSession(device=self.device)
        session.deploy(ServingSpec(endpoints=(ep,)), engines={name: engine})
        if cache is not None:
            session.warm(name, cache)
        return session

    # -- wire-level entry point ------------------------------------------------
    def handle_wire(
        self, name: str, wire: List[Tuple[float, bytes]]
    ) -> Tuple[List[bytes], ServingMetrics, CodecStats]:
        """wire: [(arrival_s, encoded_request_bytes)] -> encoded responses."""
        stats = CodecStats()
        requests = []
        for arrival, data in wire:
            stats.request_bytes += len(data)
            # sanctioned measurement: codec cost is real host work (TD4),
            # reported in CodecStats — it never touches the virtual timeline
            t0 = time.perf_counter()              # simlint: allow(wall-clock)
            rid, tokens, max_new = self.codec.decode_request(data)
            dt = time.perf_counter() - t0         # simlint: allow(wall-clock)
            stats.decode_s += dt
            requests.append(
                Request(rid=rid, prompt=tokens, max_new_tokens=max_new,
                        arrival_s=arrival)
            )
        metrics = self.handle(name, requests)
        out = []
        for resp in metrics.responses:
            t0 = time.perf_counter()              # simlint: allow(wall-clock)
            data = self.codec.encode_response(resp.rid, resp.tokens)
            dt = time.perf_counter() - t0         # simlint: allow(wall-clock)
            stats.encode_s += dt
            stats.response_bytes += len(data)
            out.append(data)
        return out, metrics, stats

    # -- object-level entry point (used by SI4 and benchmarks) -----------------
    def handle(self, name: str, workload: List[Request]) -> ServingMetrics:
        """Serve one workload through the declarative session facade."""
        session = self._session(name)
        session.submit(name, workload)
        return session.run().endpoints[name].metrics
