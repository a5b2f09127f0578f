"""TD1 'Containerized': deployment artifact generation + overhead model.

Real Docker/WASM energy deltas cannot be measured inside this container, so
TD1 is realized as (i) honest artifact generators — the Dockerfile / OCI spec
a deployment would ship with — and (ii) an overhead model CALIBRATED to the
paper's primary study (Hampau et al., EASE 2022: containerization adds small
steady-state CPU/energy overhead, WASM trades throughput for portability).
Every number from the model is flagged ``simulated``.
"""

from __future__ import annotations

import dataclasses
import json

from repro_torch.core.add import Containerization, Deployment


@dataclasses.dataclass(frozen=True)
class ContainerOverhead:
    cold_start_s: float        # added to first-request latency
    energy_overhead: float     # multiplicative on steady-state energy
    latency_overhead: float    # multiplicative on per-request latency
    rss_overhead_mb: float
    portability_score: int     # 1-5 qualitative (paper: wasm most portable)
    simulated: bool = True


# Calibrated to Hampau'22 (docker ~2-8% energy overhead on CV tasks; wasm
# 1.5-3x runtime on compute-heavy paths but near-universal portability).
OVERHEADS = {
    Containerization.NONE: ContainerOverhead(0.0, 1.00, 1.00, 0.0, 2),
    Containerization.DOCKER: ContainerOverhead(1.8, 1.05, 1.02, 180.0, 4),
    Containerization.WASM: ContainerOverhead(0.4, 1.35, 1.60, 40.0, 5),
}


def overhead(option: Containerization) -> ContainerOverhead:
    return OVERHEADS[option]


def generate_dockerfile(dep: Deployment) -> str:
    return f"""# auto-generated by repro_torch.serving.container for {dep.arch}
FROM python:3.13-slim
RUN pip install --no-cache-dir torch numpy
COPY src /app/src
COPY models/{dep.arch}.{dep.model_format.value} /app/model
ENV PYTHONPATH=/app/src \\
    REPRO_ARCH={dep.arch} \\
    REPRO_SI={dep.si.value} \\
    REPRO_PROCESSING={dep.request_processing.value} \\
    REPRO_MAX_BATCH={dep.max_batch}
EXPOSE 8000
ENTRYPOINT ["python", "-m", "repro_torch.launch.serve", "--arch", "{dep.arch}"]
"""


def generate_oci_runtime_config(dep: Deployment) -> str:
    return json.dumps(
        {
            "ociVersion": "1.0.2",
            "process": {
                "args": ["python", "-m", "repro_torch.launch.serve",
                         "--arch", dep.arch],
                "env": [f"REPRO_SI={dep.si.value}"],
            },
            "annotations": {
                "repro_torch.deployment": dep.describe(),
            },
        },
        indent=1,
    )


def generate_artifact(dep: Deployment) -> str:
    if dep.containerization == Containerization.DOCKER:
        return generate_dockerfile(dep)
    if dep.containerization == Containerization.WASM:
        return json.dumps(
            {
                "wasm": True,
                "note": "WASI target; model weights fetched at instantiation",
                "entry": "repro_serve.wasm",
                "arch": dep.arch,
            },
            indent=1,
        )
    return "# no containerization layer (TD1 = none)\n"
