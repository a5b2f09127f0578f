"""The paper's taxonomy of ML-serving Architectural Design Decisions as code.

Durán et al. (CAIN 2024) identify one principal decision — the *Serving
Infrastructure* (SI1..SI4) — and four *Transversal Decisions* (TD1..TD4).
A ``Deployment`` is a complete assignment of options to decisions; the
``validate`` method enforces the inter-decision compatibility constraints the
paper describes in §4.1 ("certain options ... lack compatibility with specific
serving infrastructure").
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List


class ServingInfrastructure(enum.Enum):
    """Principal ADD (paper Fig. 1). PyTorch/CUDA realizations in comments."""

    SI1_NO_RUNTIME = "si1_no_runtime"        # eager op-by-op dispatch
    SI2_RUNTIME_ENGINE = "si2_runtime"       # decode step captured as a CUDA graph
    SI3_DL_SERVER = "si3_dl_server"          # packaged server w/ batching
    SI4_CLOUD_SERVICE = "si4_cloud"          # registry + autoscaled endpoints


class Containerization(enum.Enum):          # TD1
    NONE = "none"
    DOCKER = "docker"
    WASM = "wasm"


class ModelFormat(enum.Enum):               # TD2
    NATIVE = "native"                        # framework-native tree (npz)
    RSM = "rsm"                              # repro-saved-model (manifest+raw)
    RSM_INT8 = "rsm_int8"                    # optimized: per-channel int8


class RequestProcessing(enum.Enum):         # TD3
    REALTIME = "realtime"
    DYNAMIC_BATCH = "dynamic_batch"
    CONTINUOUS_BATCH = "continuous_batch"    # beyond-paper (vLLM-style)
    ADAPTIVE_BATCH = "adaptive_batch"        # beyond-paper (SLO/energy-aware)


class Protocol(enum.Enum):                  # TD4
    REST_JSON = "rest_json"
    GRPC_BINARY = "grpc_binary"


@dataclasses.dataclass(frozen=True)
class Deployment:
    """A full assignment of the paper's design decisions for one endpoint."""

    arch: str
    si: ServingInfrastructure = ServingInfrastructure.SI2_RUNTIME_ENGINE
    containerization: Containerization = Containerization.NONE
    model_format: ModelFormat = ModelFormat.RSM
    request_processing: RequestProcessing = RequestProcessing.DYNAMIC_BATCH
    protocol: Protocol = Protocol.GRPC_BINARY
    # batching knobs (TD3 parameters)
    max_batch: int = 8
    batch_timeout_ms: float = 20.0
    max_seq: int = 256
    ttft_slo_ms: float = 200.0  # p95 TTFT target (adaptive_batch sizing)
    # SI4 knobs
    min_replicas: int = 1
    max_replicas: int = 1  # >1 only meaningful under SI4 (cloud autoscaling)
    # SI4 fleet knobs: per-arrival replica routing and virtual-time
    # autoscaling (see repro_torch.serving.fleet)
    # router: round_robin | least_loaded | warmest | greenest
    router: str = "round_robin"
    autoscale_window_s: float = 1.0    # pool re-sized every W virtual seconds
    cold_start_s: float = 0.25         # scale-up provisioning penalty

    def validate(self) -> List[str]:
        """Returns a list of violated compatibility constraints (empty = ok)."""
        errs = []
        si, rp = self.si, self.request_processing
        if rp == RequestProcessing.CONTINUOUS_BATCH and si in (
            ServingInfrastructure.SI1_NO_RUNTIME,
        ):
            # continuous batching needs a compiled decode step + slot manager,
            # which the bare-framework option does not provide
            errs.append("continuous batching requires SI2+ (compiled decode)")
        if si == ServingInfrastructure.SI1_NO_RUNTIME and \
                self.model_format == ModelFormat.RSM_INT8:
            # the optimized format is consumed by the runtime-engine kernel
            errs.append("rsm_int8 requires a runtime engine (SI2/SI3/SI4)")
        if self.max_batch < 1:
            errs.append("max_batch must be >= 1")
        if rp == RequestProcessing.REALTIME and self.max_batch != 1:
            errs.append("realtime processing implies max_batch == 1")
        if self.min_replicas > self.max_replicas:
            errs.append("min_replicas > max_replicas")
        if si != ServingInfrastructure.SI4_CLOUD_SERVICE and \
                self.max_replicas > 1:
            errs.append("autoscaling replicas are an SI4 (cloud) capability")
        from repro_torch.serving.fleet import ROUTERS  # deferred: avoids a cycle

        if self.router not in ROUTERS:
            errs.append(f"unknown router {self.router!r}; "
                        f"known: {sorted(ROUTERS)}")
        if self.autoscale_window_s <= 0:
            errs.append("autoscale_window_s must be > 0")
        if self.cold_start_s < 0:
            errs.append("cold_start_s must be >= 0")
        return errs

    def require_valid(self) -> "Deployment":
        errs = self.validate()
        if errs:
            raise ValueError(f"invalid deployment: {errs}")
        return self

    def describe(self) -> str:
        return (
            f"{self.arch}: {self.si.value} | container={self.containerization.value}"
            f" | format={self.model_format.value} | {self.request_processing.value}"
            f"(max_batch={self.max_batch}) | {self.protocol.value}"
        )


def all_serving_infrastructures():
    return list(ServingInfrastructure)


def default_deployment(arch: str, **kw) -> Deployment:
    d = Deployment(arch=arch, **kw)
    d.require_valid()
    return d
