"""The port's declarative serving API against the JAX package's.

Framework-free code must match bit for bit, so every comparison is ``==``:

  * spec JSON: the JAX package's own alternates table
    (``tests/test_spec_roundtrip.py``: every field of every sub-spec) is
    written by one package and read by the other, both ways;
  * validation: each invalid mutation raises ``SpecError`` in both packages
    with the same field path and message, and the specs the reference
    accepts (rwkv6 served from ``rsm_int8`` among them) pass in both;
  * grids: ``sweep`` and ``with_override`` give the same variants and the
    same errors;
  * replayed sessions on fake engines, or on engines built from the TD2
    formats behind a warm StepTimeCache: every ``ServingReport`` (its JSON,
    per-endpoint metrics, meters and responses) equals the reference's;
  * the green report, the roofline estimator (given one explicit
    ``ChipSpec`` each), the quality table and the TD1 artifacts.  The
    artifacts differ in two things only: the framework the Dockerfile
    installs (jax -> torch) and the package they name (repro ->
    repro_torch: the launcher module, the generator module and the OCI
    annotation's namespace).
"""

import dataclasses
import types

import jax
import numpy as np
import pytest

import test_spec_roundtrip as j_rt   # the reference's alternates table

import repro.carbon as j_carbon
import repro.configs as j_configs
import repro.core.add as j_add
import repro.core.engines as j_engines
import repro.core.quality as j_quality
import repro.energy.estimator as j_est
import repro.energy.hw as j_hw
import repro.energy.report as j_report
import repro.serving.admission as j_admission
import repro.serving.api as j_api
import repro.serving.chaos as j_chaos
import repro.serving.container as j_container
import repro.serving.monitor as j_monitor
import repro.serving.regions as j_regions
import repro.serving.request as j_request
import repro.serving.stepcache as j_step
import repro.serving.telemetry as j_telemetry
import repro.workload as j_workload
from repro.models import init_params as j_init_params
import repro_torch.carbon as t_carbon
import repro_torch.configs as t_configs
import repro_torch.core.add as t_add
import repro_torch.core.engines as t_engines
import repro_torch.core.quality as t_quality
import repro_torch.energy.estimator as t_est
import repro_torch.energy.hw as t_hw
import repro_torch.energy.report as t_report
import repro_torch.serving.admission as t_admission
import repro_torch.serving.api as t_api
import repro_torch.serving.chaos as t_chaos
import repro_torch.serving.container as t_container
import repro_torch.serving.monitor as t_monitor
import repro_torch.serving.regions as t_regions
import repro_torch.serving.request as t_request
import repro_torch.serving.stepcache as t_step
import repro_torch.serving.telemetry as t_telemetry
import repro_torch.workload as t_workload
from repro_torch.models import transformer as T
from repro_torch.serving.formats import QTensor

ARCH = "minitron-4b-smoke"
PK = {
    name: types.SimpleNamespace(
        name=name, add=add, admission=admission, api=api, carbon=carbon, chaos=chaos,
        configs=configs, engines=engines, monitor=monitor, regions=regions,
        request=request, step=step, telemetry=telemetry, workload=workload)
    for name, (add, admission, api, carbon, chaos, configs, engines, monitor, regions,
               request, step, telemetry, workload) in {
        "ref": (j_add, j_admission, j_api, j_carbon, j_chaos, j_configs, j_engines,
                j_monitor, j_regions, j_request, j_step, j_telemetry, j_workload),
        "port": (t_add, t_admission, t_api, t_carbon, t_chaos, t_configs, t_engines,
                 t_monitor, t_regions, t_request, t_step, t_telemetry, t_workload),
    }.items()
}

# the port's spec classes by name: the reference's values convert field by field
PORT_SPECS = {c.__name__: c for c in (
    t_api.ServingSpec, t_api.EndpointSpec, t_api.AutoscaleSpec, t_api.SLOClass,
    t_carbon.CarbonSpec, t_carbon.DeferralSpec, t_admission.PrioritySpec,
    t_admission.DisaggSpec, t_workload.WorkloadSpec, t_regions.RegionSpec,
    t_chaos.ChaosSpec, t_chaos.ChaosEvent, t_chaos.RetrySpec, t_telemetry.TelemetrySpec,
    t_monitor.MonitorSpec, t_monitor.BudgetSpec)}


def to_port(v):
    """A reference spec value as the port's (dataclasses by class name)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return PORT_SPECS[type(v).__name__](
            **{f.name: to_port(getattr(v, f.name)) for f in dataclasses.fields(v)})
    if isinstance(v, tuple):
        return tuple(to_port(x) for x in v)
    if isinstance(v, dict):
        return {k: to_port(x) for k, x in v.items()}
    return v


def session(pk, **kw):
    return pk.api.ServingSession(**kw, **({"device": "cpu"} if pk.name == "port" else {}))


def assert_crosses(ref_spec, port_spec):
    """Same JSON; each package reads the other's back to an equal spec."""
    assert port_spec.to_json() == ref_spec.to_json()
    assert port_spec.to_json(indent=1) == ref_spec.to_json(indent=1)
    assert t_api.ServingSpec.from_json(ref_spec.to_json()) == port_spec
    assert j_api.ServingSpec.from_json(port_spec.to_json()) == ref_spec


# -- spec JSON across packages --------------------------------------------------------


@pytest.mark.parametrize("cls", list(j_rt.ALTERNATES), ids=lambda c: c.__name__)
def test_port_spec_classes_have_the_reference_fields(cls):
    port = PORT_SPECS[cls.__name__]
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(cls)]
    assert {f.name for f in dataclasses.fields(port)} == set(j_rt.ALTERNATES[cls])


def test_baseline_spec_crosses_packages():
    ref = j_rt.baseline_spec()
    port = to_port(ref).validate()
    assert_crosses(ref, port)
    default = j_api.ServingSpec(endpoints=(j_api.EndpointSpec(name="m", arch=ARCH),))
    assert_crosses(default, t_api.ServingSpec(
        endpoints=(t_api.EndpointSpec(name="m", arch=ARCH),)))


@pytest.mark.parametrize("cls,field", j_rt._PATH_CASES,
                         ids=[f"{c.__name__}.{f}" for c, f in j_rt._PATH_CASES])
def test_every_field_crosses_packages(cls, field):
    base = j_rt.baseline_spec()
    path, alt = j_rt.ALTERNATES[cls][field]
    ref = j_api.with_override(base, path, alt).validate()
    port = t_api.with_override(to_port(base), path, to_port(alt)).validate()
    assert_crosses(ref, port)


def _held_value(cls, field):
    """The reference's override of a field that lives inside a mapping or a
    tuple (SLO classes, chaos events, budgets): (path, new whole value)."""
    base = j_rt.baseline_spec()
    _, alt = j_rt.ALTERNATES[cls][field]
    if cls is j_api.SLOClass:
        classes = dict(base.endpoints[0].slo_classes)
        classes["interactive"] = dataclasses.replace(classes["interactive"], **{field: alt})
        return "endpoints.chat.slo_classes", classes
    if cls is j_chaos.ChaosEvent:
        event = j_chaos.ChaosEvent(kind="brownout", t_s=2.0, target="apac", duration_s=1.0,
                                   power_cap_frac=0.5)
        return "chaos.events", (dataclasses.replace(event, **{field: alt}),)
    return "monitor.budgets", (dataclasses.replace(base.monitor.budgets[0], **{field: alt}),)


HELD = [(cls, f) for cls in (j_api.SLOClass, j_chaos.ChaosEvent, j_monitor.BudgetSpec)
        for f in sorted(j_rt.ALTERNATES[cls])]


@pytest.mark.parametrize("cls,field", HELD, ids=[f"{c.__name__}.{f}" for c, f in HELD])
def test_fields_held_in_mappings_and_tuples_cross_packages(cls, field):
    path, value = _held_value(cls, field)
    base = j_rt.baseline_spec()
    ref = j_api.with_override(base, path, value).validate()
    port = t_api.with_override(to_port(base), path, to_port(value)).validate()
    assert_crosses(ref, port)


def test_sweep_gives_the_same_grid():
    overrides = {"router": ["round_robin", "greenest"], "endpoints.chat.max_batch": [1, 8],
                 "carbon.g_per_kwh": [100.0, 300.0], "endpoints.*.slo_classes.*.slo_ms": [60.0]}
    ref = j_api.sweep(j_rt.baseline_spec(), overrides)
    port = t_api.sweep(to_port(j_rt.baseline_spec()), overrides)
    assert [a for a, _ in port] == [a for a, _ in ref] and len(ref) == 8
    assert [v.to_json() for _, v in port] == [v.to_json() for _, v in ref]


# -- validation: the same accept/reject set and field paths ----------------------------


def base_spec(pk, **kw):
    """``tests/test_spec_api.py``'s base spec, in package ``pk``."""
    api = pk.api
    eps = kw.pop("endpoints", None) or (
        api.EndpointSpec(name="chat", arch=ARCH, max_batch=8,
                         slo_classes={"interactive": api.SLOClass(slo_ms=100.0),
                                      "batch": api.SLOClass(slo_ms=None)}),
        api.EndpointSpec(name="bulk", arch=ARCH, policy="adaptive_batch"),
    )
    return api.ServingSpec(endpoints=eps, **kw)


def _ep(pk, **kw):
    return pk.api.EndpointSpec(**{"name": "chat", "arch": ARCH, **kw})


INVALID = [
    # tests/test_spec_api.py:138
    ("router", lambda pk, s: dataclasses.replace(s, router="zigzag")),
    ("ttft_budget_s", lambda pk, s: dataclasses.replace(s, ttft_budget_s=-1.0)),
    ("endpoints[chat].policy", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.policy", "mystery")),
    ("endpoints[chat].format", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.format", "onnx")),
    ("endpoints[chat].ttft_slo_ms", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.ttft_slo_ms", -5.0)),
    ("endpoints[bulk].autoscale.min_replicas", lambda pk, s: pk.api.with_override(
        s, "endpoints.bulk.autoscale", pk.api.AutoscaleSpec(min_replicas=3, max_replicas=1))),
    ("endpoints[bulk].autoscale.window_s", lambda pk, s: pk.api.with_override(
        s, "endpoints.bulk.autoscale", pk.api.AutoscaleSpec(window_s=-0.5))),
    ("endpoints[chat].slo_classes[rt].slo_ms", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.slo_classes", {"rt": pk.api.SLOClass(slo_ms=-10.0)})),
    # the rest of the reference's tests, its §4.1 constraints and every check
    ("endpoints[1].name", lambda pk, s: dataclasses.replace(
        s, endpoints=(s.endpoints[0], s.endpoints[0]))),
    ("endpoints[*].autoscale.window_s", lambda pk, s: pk.api.with_override(
        s, "endpoints.bulk.autoscale", pk.api.AutoscaleSpec(window_s=2.0))),
    ("endpoints[chat].format", lambda pk, s: dataclasses.replace(s, endpoints=(_ep(
        pk, si="si1_no_runtime", format="rsm_int8", autoscale=pk.api.AutoscaleSpec(
            max_replicas=1)),))),
    ("endpoints[chat].policy", lambda pk, s: dataclasses.replace(s, endpoints=(_ep(
        pk, si="si1_no_runtime", policy="continuous_batch", autoscale=pk.api.AutoscaleSpec(
            max_replicas=1)),))),
    ("endpoints[chat].autoscale.max_replicas", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.si", "si3_dl_server")),
    ("endpoints[chat].max_batch", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.policy", "realtime")),
    ("endpoints[chat].autoscale.enabled", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.disagg", pk.admission.DisaggSpec(enabled=True))),
    ("endpoints[chat].disagg.prefill_replicas", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.disagg", pk.admission.DisaggSpec(prefill_replicas=0))),
    ("endpoints[chat].workload.n", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.workload", pk.workload.WorkloadSpec(n=0))),
    ("endpoints[chat].idle_power_w", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.idle_power_w", -1.0)),
    ("active_power_w", lambda pk, s: dataclasses.replace(s, active_power_w=0.0)),
    ("monitor.enabled", lambda pk, s: dataclasses.replace(
        s, monitor=pk.monitor.MonitorSpec(enabled=True))),
    ("monitor.budgets[0].endpoint", lambda pk, s: dataclasses.replace(
        s, telemetry=pk.telemetry.TelemetrySpec(enabled=True),
        monitor=pk.monitor.MonitorSpec(enabled=True, budgets=(pk.monitor.BudgetSpec(
            name="j", kind="joules", budget=1.0, endpoint="ghost"),)))),
    ("chaos.events[0].target", lambda pk, s: dataclasses.replace(
        s, chaos=pk.chaos.ChaosSpec(events=(pk.chaos.ChaosEvent(
            kind="outage", t_s=1.0, target="mars", duration_s=1.0),)))),
    ("endpoints[chat].zones", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.zones", ("nowhere",))),
    ("regions[eu]", lambda pk, s: dataclasses.replace(
        s, carbon_zones={"eu": pk.carbon.CarbonSpec()},
        regions={"eu": pk.regions.RegionSpec()})),
    ("deferral.window_s", lambda pk, s: dataclasses.replace(
        s, deferral=pk.carbon.DeferralSpec(window_s=0.0))),
    ("endpoints", lambda pk, s: dataclasses.replace(s, endpoints=())),
    ("endpoints[].name", lambda pk, s: pk.api.with_override(s, "endpoints.chat.name", "")),
    ("endpoints[chat].arch", lambda pk, s: pk.api.with_override(s, "endpoints.chat.arch", "")),
    ("endpoints[chat].si", lambda pk, s: pk.api.with_override(s, "endpoints.chat.si", "si9")),
    ("endpoints[chat].container", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.container", "vm")),
    ("endpoints[chat].protocol", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.protocol", "smtp")),
    ("endpoints[chat].max_batch", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.max_batch", 0)),
    ("endpoints[chat].batch_timeout_ms", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.batch_timeout_ms", -1.0)),
    ("endpoints[chat].max_seq", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.max_seq", 0)),
    ("endpoints[chat].service_time_hint_s", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.service_time_hint_s", 0.0)),
    ("endpoints[chat].active_power_w", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.active_power_w", 0.0)),
    ("endpoints[chat].disagg.enabled", lambda pk, s: pk.api.with_override(pk.api.with_override(
        pk.api.with_override(s, "endpoints.chat.autoscale.max_replicas", 1),
        "endpoints.chat.si", "si2_runtime"), "endpoints.chat.disagg",
        pk.admission.DisaggSpec(enabled=True))),
    ("endpoints[chat].policy", lambda pk, s: pk.api.with_override(pk.api.with_override(
        pk.api.with_override(s, "endpoints.chat.autoscale.enabled", False),
        "endpoints.chat.policy", "continuous_batch"), "endpoints.chat.disagg",
        pk.admission.DisaggSpec(enabled=True))),
    ("endpoints[chat].autoscale.max_replicas", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.autoscale.max_replicas", 0)),
    ("endpoints[chat].autoscale.replicas_hint", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.autoscale.replicas_hint", 0)),
    ("endpoints[chat].autoscale.target_utilization", lambda pk, s: pk.api.with_override(
        s, "endpoints.*.autoscale.target_utilization", 1.5)),
    ("endpoints[chat].autoscale.cold_start_s", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.autoscale.cold_start_s", -0.1)),
    ("endpoints[chat].autoscale.down_windows", lambda pk, s: pk.api.with_override(
        s, "endpoints.*.autoscale.down_windows", 0)),
    ("endpoints[chat].autoscale.carbon_bias", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.autoscale.carbon_bias", -1.0)),
    ("endpoints[chat].autoscale.calendar", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.autoscale.calendar", ((1.0, 2.0), (1.0, 3.0)))),
    ("endpoints[chat].autoscale.calendar", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.autoscale.calendar", ((1.0, -2.0),))),
    ("endpoints[chat].slo_classes[rt].deadline_s", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.slo_classes", {"rt": pk.api.SLOClass(deadline_s=0.0)})),
    ("endpoints[chat].slo_classes[rt].priority", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.slo_classes", {"rt": pk.api.SLOClass(priority="vip")})),
    ("idle_power_w", lambda pk, s: dataclasses.replace(s, idle_power_w=-1.0)),
    ("carbon_zones", lambda pk, s: dataclasses.replace(
        s, carbon_zones={"": pk.carbon.CarbonSpec()})),
    ("carbon.g_per_kwh", lambda pk, s: dataclasses.replace(
        s, carbon=pk.carbon.CarbonSpec(g_per_kwh=-1.0))),
    ("carbon_zones[eu].kind", lambda pk, s: dataclasses.replace(
        s, carbon_zones={"eu": pk.carbon.CarbonSpec(kind="lunar")})),
    ("priority.pause_ms", lambda pk, s: dataclasses.replace(
        s, priority=pk.admission.PrioritySpec(pause_ms=-1.0))),
    ("regions[eu].latency_ms", lambda pk, s: dataclasses.replace(
        s, regions={"eu": pk.regions.RegionSpec(latency_ms=-1.0)})),
    ("retry.max_retries", lambda pk, s: dataclasses.replace(
        s, retry=pk.chaos.RetrySpec(max_retries=-1))),
    ("chaos.events[0].t_s", lambda pk, s: dataclasses.replace(
        s, chaos=pk.chaos.ChaosSpec(events=(pk.chaos.ChaosEvent(kind="crash", t_s=-1.0),)))),
    ("telemetry.max_events", lambda pk, s: dataclasses.replace(
        s, telemetry=pk.telemetry.TelemetrySpec(max_events=0))),
    ("monitor.window_s", lambda pk, s: dataclasses.replace(
        s, monitor=pk.monitor.MonitorSpec(window_s=0.0))),
    ("monitor.budgets[0].slo_class", lambda pk, s: dataclasses.replace(
        s, telemetry=pk.telemetry.TelemetrySpec(enabled=True),
        monitor=pk.monitor.MonitorSpec(enabled=True, budgets=(pk.monitor.BudgetSpec(
            name="x", kind="slo", slo_class="vip"),)))),
    ("endpoints[chat].workload.origins", lambda pk, s: pk.api.with_override(
        s, "endpoints.chat.workload", pk.workload.WorkloadSpec(origins=("mars",)))),
]


@pytest.mark.parametrize("field,mutate", INVALID,
                         ids=[f"{i}-{f}" for i, (f, _) in enumerate(INVALID)])
def test_validation_rejects_with_the_same_field_path(field, mutate):
    errors = {}
    for name, pk in PK.items():
        with pytest.raises(pk.api.SpecError) as e:
            mutate(pk, base_spec(pk)).validate()
        errors[name] = (e.value.field, str(e.value))
    assert errors["port"] == errors["ref"]
    assert errors["ref"][0] == field


@pytest.mark.parametrize("arch,fmt", [("rwkv6-3b-smoke", "rsm_int8"),
                                      ("mixtral-8x7b-smoke", "rsm_int8"),
                                      ("minitron-4b-smoke", "native")])
def test_validation_accepts_what_the_reference_accepts(arch, fmt):
    """rwkv6 from rsm_int8 (F2) is accepted by the reference's validate, so
    the port's is too: its load fence dequantizes the leaves rwkv6 does not
    send through dense()."""
    specs = {name: pk.api.with_override(
        pk.api.with_override(base_spec(pk), "endpoints.*.arch", arch),
        "endpoints.chat.format", fmt).validate() for name, pk in PK.items()}
    assert specs["port"].to_json() == specs["ref"].to_json()


def _error(fn):
    try:
        fn()
    except Exception as e:              # both packages' SpecError
        return type(e).__name__, getattr(e, "field", None), str(e)
    return None


@pytest.mark.parametrize("case", [
    lambda pk: pk.api.with_override(base_spec(pk), "endpoints.chat.exotic_knob", 1),
    lambda pk: pk.api.with_override(base_spec(pk), "endpoints.ghost.format", "rsm"),
    lambda pk: pk.api.with_override(base_spec(pk), "endpoints.chat", "rsm"),
    lambda pk: pk.api.with_override(base_spec(pk), "endpoints.bulk.workload.rate_per_s", 1.0),
    lambda pk: pk.api.with_override(base_spec(pk), "endpoints.chat.slo_classes.premium.slo_ms",
                                    1.0),
    lambda pk: pk.api.with_override(base_spec(pk), "endpoints.chat.slo_classes.interactive",
                                    1.0),
    lambda pk: pk.api.sweep(base_spec(pk), {"endpoints.chat.policy": ["warp_drive"]}),
    lambda pk: base_spec(pk).endpoint("ghost"),
    lambda pk: pk.api.ServingSpec.from_dict({"endpoints": [], "rooter": "greenest"}),
    lambda pk: pk.api.ServingSpec.from_dict({"endpoints": [
        {"name": "m", "arch": ARCH, "autoscale": {"widnow_s": 1.0}}]}),
    lambda pk: pk.api.ServingSpec.from_dict({"endpoints": [{"name": "m", "arch": ARCH,
                                                            "polcy": "x"}]}),
    lambda pk: pk.api.ServingSpec.from_dict({"endpoints": [], "chaos": {"events": [
        {"kind": "crash", "t_s": 1.0, "turbo": 1}]}}),
], ids=["no_field", "no_endpoint", "short_path", "unset", "no_key", "key_needs_field",
        "sweep_invalid", "endpoint_lookup", "from_dict_top", "from_dict_autoscale",
        "from_dict_endpoint", "from_dict_chaos_event"])
def test_override_and_from_dict_errors_match(case):
    got, want = _error(lambda: case(PK["port"])), _error(lambda: case(PK["ref"]))
    assert want is not None and want[0] == "SpecError"
    assert got == want


def _deployments(pk):
    add = pk.add
    out = []
    for si in add.ServingInfrastructure:
        for fmt in add.ModelFormat:
            for rp in add.RequestProcessing:
                for c in add.Containerization:
                    out.append(add.Deployment(
                        arch=ARCH, si=si, model_format=fmt, request_processing=rp,
                        containerization=c, protocol=add.Protocol.REST_JSON,
                        max_batch=1 if rp == add.RequestProcessing.REALTIME else 4,
                        max_replicas=3 if si == add.ServingInfrastructure.SI4_CLOUD_SERVICE
                        else 1, router="greenest"))
    out += [add.Deployment(arch=ARCH, max_batch=0, min_replicas=2, router="zigzag",
                           autoscale_window_s=0.0, cold_start_s=-1.0),
            add.Deployment(arch=ARCH, request_processing=add.RequestProcessing.REALTIME,
                           max_replicas=2)]
    return out


def test_deployments_validate_describe_and_bridge_alike():
    ref, port = _deployments(PK["ref"]), _deployments(PK["port"])
    assert [d.validate() for d in port] == [d.validate() for d in ref]
    assert [d.describe() for d in port] == [d.describe() for d in ref]
    valid = [(r, p) for r, p in zip(ref, port) if not r.validate()]
    assert len(valid) == 126
    for r, p in valid:
        for kw in ({}, dict(model="m", version=2, max_seq=64, autoscale_enabled=False)):
            ep_r = j_api.endpoint_from_deployment("m", r, **kw)
            ep_p = t_api.endpoint_from_deployment("m", p, **kw)
            assert_crosses(j_api.ServingSpec(endpoints=(ep_r,)),
                           t_api.ServingSpec(endpoints=(ep_p,)))
    with pytest.raises(ValueError) as e_ref:
        ref[-1].require_valid()
    with pytest.raises(ValueError) as e_port:
        port[-1].require_valid()
    assert str(e_port.value) == str(e_ref.value)
    assert t_add.default_deployment(ARCH) == dataclasses.replace(
        t_add.Deployment(arch=ARCH))
    assert [s.value for s in t_add.all_serving_infrastructures()] == \
        [s.value for s in j_add.all_serving_infrastructures()]


def test_autoscale_initial_pool_matches():
    for hint in (None, 3):
        for rate in (0.1, 5.0, 100.0, 1000.0):
            for svc in (0.01, 0.2):
                kw = dict(min_replicas=1, max_replicas=4, target_utilization=0.7,
                          replicas_hint=hint)
                assert t_api.AutoscaleSpec(**kw).initial_pool(rate, svc) == \
                    j_api.AutoscaleSpec(**kw).initial_pool(rate, svc)


# -- replayed sessions ----------------------------------------------------------------


class FakeEngine:
    """Deterministic timings, no model; returns its package's GenerationResult."""

    def __init__(self, pk, prefill_s=0.01, step_s=0.005):
        self.pk = pk
        self.prefill_s = prefill_s
        self.step_s = step_s
        self.cfg = pk.configs.get_arch(ARCH)

    def generate(self, tokens, max_new):
        B = tokens.shape[0]
        toks = (np.arange(B * max_new, dtype=np.int32).reshape(B, max_new)
                + int(np.asarray(tokens).sum()) % 97)
        return self.pk.engines.GenerationResult(
            tokens=toks, prefill_s=self.prefill_s * (1 + 0.25 * B),
            decode_s=self.step_s * (1 + 0.1 * B) * (max_new - 1), n_steps=max_new)


def _meter(m):
    d = dataclasses.asdict(m)
    d.pop("carbon")
    return d


def _metrics(m):
    return (m.summary(), m.fleet, m.wall_compute_s, m.energy_j, m.total_tokens,
            _meter(m.meter),
            [(r.rid, r.arrival_s, r.start_s, r.first_token_s, r.done_s, r.deadline_s,
              r.priority, np.asarray(r.tokens).tolist()) for r in m.responses])


def observe(report) -> dict:
    return {"json": report.to_json(), "fleet": _metrics(report.fleet.metrics),
            "endpoints": {n: _metrics(r.metrics) for n, r in report.endpoints.items()}}


def both(scenario):
    """Run ``scenario(pk) -> report`` in both packages; returns (port's
    observables, reference's, port's report)."""
    out = {name: scenario(pk) for name, pk in PK.items()}
    return observe(out["port"]), observe(out["ref"]), out["port"]


def _single(pk):
    api = pk.api
    s = session(pk)
    s.deploy(api.ServingSpec(endpoints=(api.EndpointSpec(
        name="m", arch=ARCH, max_batch=4, autoscale=api.AutoscaleSpec(
            max_replicas=3, window_s=0.5, cold_start_s=0.1)),), router="least_loaded"),
        engines={"m": FakeEngine(pk)})
    s.submit("m", pk.request.synth_workload(120, 8, 5, 1000, rate_per_s=150, seed=7))
    return s.run()


def test_single_endpoint_replay_bit_identical():
    got, want, rep = both(_single)
    assert got == want
    # M/M/c sizing at 150 req/s and the 0.1 s hint, clamped to max_replicas
    assert rep.fleet.n_requests == 120 and rep.endpoints["m"].metrics.fleet["peak_replicas"] == 3


@pytest.fixture(scope="module")
def smoke_params():
    cfg = j_configs.get_arch(ARCH)
    jp = j_init_params(cfg, jax.random.PRNGKey(0))
    return {"ref": jp, "port": T.params_from_numpy(jax.tree.map(np.asarray, jp),
                                                    t_configs.get_arch(ARCH), device="cpu")}


def _warm(pk, max_new=3, prompt_len=8, batches=range(1, 5)):
    cache = pk.step.StepTimeCache()
    sb = pk.step.shape_bucket(prompt_len)
    for b in batches:
        cache.put(("generate", b, sb, max_new), (0.004 + 0.0013 * b, (0.010 + 0.0021 * b)))
    return cache


def _heterogeneous(pk, params, tmp):
    """rsm + rsm_int8 behind one router, engines built through the formats on
    disk, every dispatch replayed from a warm cache."""
    api = pk.api
    spec = api.ServingSpec(endpoints=tuple(
        api.EndpointSpec(name=name, arch=ARCH, format=fmt, model="m", max_seq=64, max_batch=4,
                         autoscale=api.AutoscaleSpec(max_replicas=2))
        for name, fmt in (("chat", "rsm"), ("bulk", "rsm_int8"))), router="least_loaded")
    s = session(pk, registry_root=str(tmp / pk.name))
    s.deploy(spec, params={"m": params[pk.name]})
    for name in ("chat", "bulk"):
        s.warm(name, _warm(pk))
    rep = s.serve({
        "chat": pk.request.synth_workload(40, 8, 3, 1000, rate_per_s=150, seed=1),
        "bulk": pk.request.synth_workload(40, 8, 3, 1000, rate_per_s=150, seed=2,
                                          rid0=10_000)})
    rep.session = s
    return rep


def test_heterogeneous_int8_fp32_endpoints_replay_bit_identical(smoke_params, tmp_path):
    got, want, rep = both(lambda pk: _heterogeneous(pk, smoke_params, tmp_path))
    assert got == want
    s = rep.session
    leaves = lambda t: [x for v in t.values() for x in (leaves(v) if isinstance(v, dict)  # noqa
                                                         else [v])]
    assert any(isinstance(x, QTensor) for x in leaves(s.engine("bulk").params))
    assert not any(isinstance(x, QTensor) for x in leaves(s.engine("chat").params))
    assert isinstance(s.engine("bulk"), t_engines.CompiledEngine)
    assert s.engine("bulk").device.type == "cpu"
    sources = set(rep.fleet.metrics.meter.by_source)
    assert {x.split("/")[0] for x in sources} == {"chat", "bulk"}


def test_engine_memo_keys_on_params_identity(smoke_params, tmp_path):
    spec = t_api.ServingSpec(endpoints=(t_api.EndpointSpec(
        name="m", arch=ARCH, format="rsm", max_seq=64),))
    s = t_api.ServingSession(registry_root=str(tmp_path), device="cpu")
    s.deploy(spec, params={"m": smoke_params["port"]})
    e1 = s.engine("m")
    s.deploy(t_api.with_override(spec, "router", "greenest"),
             params={"m": smoke_params["port"]})
    assert s.engine("m") is e1
    other = T.init_params(t_configs.get_arch(ARCH), 1, device="cpu")
    s.deploy(spec, params={"m": other})
    assert s.engine("m") is not e1


def _container(pk, container):
    api = pk.api
    spec = api.ServingSpec(endpoints=(api.EndpointSpec(
        name="m", arch=ARCH, container=container, autoscale=api.AutoscaleSpec(
            max_replicas=2)),))
    s = session(pk)
    s.deploy(spec, engines={"m": FakeEngine(pk)})
    s.submit("m", pk.request.synth_workload(50, 8, 4, 100, rate_per_s=100, seed=3))
    rep = s.run()
    rep.cold_start_s = s._fleet_endpoint(spec.endpoints[0], []).cold_start_s
    return rep


@pytest.mark.parametrize("container", ["none", "docker", "wasm"])
def test_container_overhead_and_cold_start_replay_bit_identical(container):
    got, want, rep = both(lambda pk: _container(pk, container))
    assert got == want
    assert rep.cold_start_s == 0.25 + t_container.overhead(
        t_add.Containerization(container)).cold_start_s
    assert (rep.endpoints["m"].j_container_overhead > 0) == (container != "none")


def _frozen(pk):
    api = pk.api
    spec = api.ServingSpec(endpoints=tuple(
        api.EndpointSpec(name=name, arch=ARCH, autoscale=api.AutoscaleSpec(
            enabled=enabled, min_replicas=1, max_replicas=4, replicas_hint=hint,
            window_s=0.25, cold_start_s=0.05))
        for name, enabled, hint in (("scaled", True, 1), ("frozen", False, 2))),
        router="least_loaded")
    s = session(pk)
    s.deploy(spec, engines={"scaled": FakeEngine(pk), "frozen": FakeEngine(pk)})
    return s.serve({
        "scaled": pk.request.synth_workload(400, 8, 4, 100, rate_per_s=600, seed=6),
        "frozen": pk.request.synth_workload(400, 8, 4, 100, rate_per_s=600, seed=7,
                                            rid0=10_000)})


def test_frozen_endpoint_in_a_mixed_fleet_replay_bit_identical():
    got, want, rep = both(_frozen)
    assert got == want
    assert rep.endpoints["frozen"].metrics.fleet["scale_events"] == []
    assert rep.endpoints["scaled"].metrics.fleet["scale_events"]


def _slo_floor(pk, budget_ms, global_s=None):
    api = pk.api
    spec = api.ServingSpec(endpoints=(api.EndpointSpec(
        name="chat", arch=ARCH, ttft_slo_ms=5000.0,
        slo_classes={"rt": api.SLOClass(slo_ms=budget_ms)}),), ttft_budget_s=global_s)
    s = session(pk)
    s.deploy(spec, engines={"chat": FakeEngine(pk)})
    cache = pk.step.StepTimeCache()
    cache.put(("generate", 1, pk.step.shape_bucket(8), 4), (0.05, 0.015))
    s.warm("chat", cache)
    s.submit("chat", pk.request.synth_workload(5, 8, 4, 100, rate_per_s=50, seed=0),
             slo_class="rt")
    return s.run()


@pytest.mark.parametrize("budget_ms,global_s", [(10.0, None), (500.0, 0.01)])
def test_slo_floor_error_matches(budget_ms, global_s):
    got = _error(lambda: _slo_floor(PK["port"], budget_ms, global_s))
    want = _error(lambda: _slo_floor(PK["ref"], budget_ms, global_s))
    assert want is not None and want[0] == "SpecError" and got == want
    ok, ok_ref, _ = both(lambda pk: _slo_floor(pk, 500.0))
    assert ok == ok_ref


def _disagg(pk):
    api = pk.api
    spec = api.ServingSpec(endpoints=(api.EndpointSpec(
        name="pd", arch=ARCH, batch_timeout_ms=5.0, autoscale=api.AutoscaleSpec(enabled=False),
        disagg=pk.admission.DisaggSpec(enabled=True, prefill_replicas=2, decode_replicas=2,
                                       link_gbps=10.0, link_latency_ms=0.2,
                                       link_power_w=15.0)),), router="least_loaded")
    s = session(pk)
    s.deploy(spec, engines={"pd": FakeEngine(pk)})
    s.submit("pd", pk.workload.poisson(80, 12, 6, 1000, rate_per_s=200.0, seed=3))
    return s.run()


def test_disaggregation_replay_bit_identical():
    got, want, rep = both(_disagg)
    assert got == want
    assert rep.endpoints["pd"].j_xfer > 0
    assert rep.endpoints["pd"].decisions["disagg"] == "prefill/decode"


def _geo(pk, telemetry=False):
    """Regions with transit, scripted chaos and retry with failover; with
    ``telemetry`` also traced and monitored."""
    api, C = pk.api, pk.carbon.CarbonSpec
    regions = {name: pk.regions.RegionSpec(carbon=C(
        kind="diurnal", g_per_kwh=300.0, amplitude_g_per_kwh=200.0, period_s=60.0,
        phase_s=phase), latency_ms=5.0) for name, phase in (("eu", 0.0), ("us", 30.0))}
    events = (pk.chaos.ChaosEvent(kind="crash", t_s=2.0),
              pk.chaos.ChaosEvent(kind="outage", t_s=4.0, target="eu", duration_s=3.0),
              pk.chaos.ChaosEvent(kind="brownout", t_s=8.0, target="us", duration_s=2.0,
                                  power_cap_frac=0.5))
    kw = {}
    if telemetry:
        B = pk.monitor.BudgetSpec
        kw = dict(telemetry=pk.telemetry.TelemetrySpec(enabled=True),
                  monitor=pk.monitor.MonitorSpec(enabled=True, window_s=0.25, budgets=(
                      B(name="crashes", kind="crashes", budget=1.0, horizon_s=60.0,
                        fast_window_s=0.5, slow_window_s=1.0, page_burn=50.0, warn_burn=10.0),
                      B(name="chat-ttft", kind="slo", slo_class="interactive",
                        objective=0.9, fast_window_s=0.5, slow_window_s=1.0),
                      B(name="joules", kind="joules", budget=20.0, horizon_s=10.0),
                      B(name="loss", kind="loss", budget=1.0, horizon_s=10.0))))
    spec = api.ServingSpec(endpoints=(api.EndpointSpec(
        name="chat", arch=ARCH, max_batch=4, batch_timeout_ms=10.0, zones=("eu", "us"),
        slo_classes={"interactive": api.SLOClass(slo_ms=60.0, priority="interactive")},
        autoscale=api.AutoscaleSpec(min_replicas=2, max_replicas=4, replicas_hint=4,
                                    window_s=0.5)),),
        router="least_loaded", regions=regions,
        chaos=pk.chaos.ChaosSpec(events=events, seed=7),
        retry=pk.chaos.RetrySpec(max_retries=3, failover=True, degrade=True), **kw)
    rng = np.random.RandomState(5)
    t, wl = 0.0, []
    for k in range(300):
        t += rng.exponential(1.0 / 80.0)
        wl.append(pk.request.Request(
            rid=k, prompt=rng.randint(0, 100, size=16).astype(np.int32), max_new_tokens=6,
            arrival_s=t, priority=None if k % 4 else "batch", origin=("eu", "us")[k % 2]))
    s = session(pk)
    s.deploy(spec, engines={"chat": FakeEngine(pk)})
    s.submit("chat", wl, slo_class="interactive")
    return s.run()


def test_regions_chaos_and_retry_replay_bit_identical():
    got, want, rep = both(_geo)
    assert got == want
    ep = rep.endpoints["chat"]
    assert ep.j_lost > 0 and ep.availability is not None and ep.drops_by_class is not None


def test_telemetry_and_monitor_replay_bit_identical():
    got, want, rep = both(lambda pk: _geo(pk, telemetry=True))
    assert got == want
    assert rep.alerts and rep.incidents and rep.fleet.phase_breakdown
    ref = _geo(PK["ref"], telemetry=True)
    assert t_telemetry.to_perfetto(rep.telemetry) == j_telemetry.to_perfetto(ref.telemetry)
    # observers change no joule, gram or latency
    bare = observe(_geo(PK["port"]))
    assert bare["endpoints"] == got["endpoints"]


def _deferral(pk):
    api = pk.api
    spec = api.ServingSpec(
        endpoints=(api.EndpointSpec(
            name="batch", arch=ARCH, slo_classes={"batch": api.SLOClass(
                deadline_s=10.0, priority="batch")},
            autoscale=api.AutoscaleSpec(min_replicas=0, max_replicas=6, replicas_hint=2,
                                        window_s=0.5, cold_start_s=0.2)),),
        router="carbon_aware",
        carbon=pk.carbon.CarbonSpec(kind="diurnal", g_per_kwh=400.0,
                                    amplitude_g_per_kwh=350.0, period_s=8.0),
        deferral=pk.carbon.DeferralSpec(enabled=True, margin_s=1.0))
    s = session(pk)
    s.deploy(spec, engines={"batch": FakeEngine(pk)})
    s.submit("batch", pk.workload.bursty(240, 8, 4, 100, rate_per_s=20, burst_n=80,
                                         burst_every_s=8.0, burst_rate_per_s=600.0,
                                         phase_s=1.5, seed=7), slo_class="batch")
    return s.run()


def test_deferral_on_a_diurnal_signal_replay_bit_identical():
    got, want, rep = both(_deferral)
    assert got == want
    assert rep.endpoints["batch"].deadline_compliance == 1.0


def _declared(pk):
    api, W = pk.api, pk.workload.WorkloadSpec
    spec = api.ServingSpec(endpoints=(
        api.EndpointSpec(name="chat", arch=ARCH, max_batch=4, workload=W(
            kind="poisson", n=60, prompt_len=8, max_new_tokens=5, rate_per_s=120.0, seed=1,
            priority="interactive"), slo_classes={"interactive": api.SLOClass(slo_ms=80.0)}),
        api.EndpointSpec(name="bulk", arch=ARCH, format="rsm_int8", workload=W(
            kind="bursty", n=80, prompt_len=16, max_new_tokens=4, rate_per_s=40.0,
            burst_n=20, burst_every_s=0.5, burst_rate_per_s=400.0, seed=2, rid0=10_000))),
        router="greenest", priority=pk.admission.PrioritySpec(enabled=True))
    s = session(pk)
    s.deploy(spec, engines={"chat": FakeEngine(pk), "bulk": FakeEngine(pk, 0.02, 0.004)})
    return s.run_declared()


def test_run_declared_replay_bit_identical():
    got, want, rep = both(_declared)
    assert got == want
    assert rep.fleet.n_requests == 140


def test_session_errors_match():
    def cases(pk):
        api = pk.api
        spec = api.ServingSpec(endpoints=(api.EndpointSpec(name="m", arch=ARCH),))
        yield lambda: session(pk).run()
        yield lambda: session(pk).declared_workloads()
        yield lambda: session(pk).deploy(spec)
        s = session(pk).deploy(spec, engines={"m": FakeEngine(pk)})
        yield s.run
        yield s.run_declared
        yield lambda: s.submit("ghost", [])
        yield lambda: s.submit("m", [], slo_class="rt")
        bad = pk.request.synth_workload(1, 8, 4, 100, rate_per_s=1.0)
        bad[0].priority = "vip"
        yield lambda: s.submit("m", bad)

    got = [_error(f) for f in cases(PK["port"])]
    want = [_error(f) for f in cases(PK["ref"])]
    assert got == want and all(w is not None for w in want)


# -- the green report, the estimator, the quality table, the artifacts ------------------

CHIP_FIELDS = {f.name: getattr(j_hw.TPU_V5E, f.name) for f in dataclasses.fields(j_hw.ChipSpec)}
H100_FIELDS = dataclasses.asdict(t_hw.H100_SXM)


@pytest.mark.parametrize("chip", [CHIP_FIELDS, H100_FIELDS], ids=["tpu_v5e_figures", "h100"])
def test_estimator_matches_given_one_chip(chip):
    for flops, nbytes, coll, chips in ((1e12, 1e9, 0.0, 1), (5e14, 2e10, 1e9, 4),
                                       (1e9, 8e9, 5e8, 8), (0.0, 0.0, 0.0, 1)):
        t = t_est.RooflineTerms(flops, nbytes, coll, chips, chip=t_hw.ChipSpec(**chip))
        j = j_est.RooflineTerms(flops, nbytes, coll, chips, chip=j_hw.ChipSpec(**chip))
        for prop in ("t_compute", "t_memory", "t_collective", "t_step", "bottleneck",
                     "arithmetic_intensity"):
            assert getattr(t, prop) == getattr(j, prop), prop
        assert t.mfu(3e11) == j.mfu(3e11)
        assert t_est.step_power_w(t) == j_est.step_power_w(j)
        assert t_est.step_energy_j(t) == j_est.step_energy_j(j)
        for tps in (0, 1, 8):
            assert t_est.energy_per_token_j(t, tps) == j_est.energy_per_token_j(j, tps)
    sig = (t_carbon.DiurnalSignal(amplitude_g_per_kwh=200.0, period_s=10.0),
           j_carbon.DiurnalSignal(amplitude_g_per_kwh=200.0, period_s=10.0))
    for joules in (0.0, 1.5, 3.6e6):
        assert t_est.carbon_g(joules) == j_est.carbon_g(joules)
        assert t_est.carbon_g(joules, sig[0], 2.5) == j_est.carbon_g(joules, sig[1], 2.5)
        assert t_est.measured_energy_j(joules, 65.0) == j_est.measured_energy_j(joules, 65.0)
    # the port's default chip is the card, never a TPU
    assert t_est.RooflineTerms(1.0, 1.0, 0.0, 1).chip == t_hw.H100_SXM
    assert not hasattr(t_hw, "TPU_V5E") and "tpu" not in t_hw.H100_SXM.name.lower()


def test_green_report_tables_match():
    reports = {name: _single(pk) for name, pk in PK.items()}
    chips = {"ref": j_hw.ChipSpec(**H100_FIELDS), "port": t_hw.ChipSpec(**H100_FIELDS)}
    est = {"ref": j_est, "port": t_est}
    rep_mod = {"ref": j_report, "port": t_report}
    n = 0
    for d_ref, d_port in zip(_deployments(PK["ref"]), _deployments(PK["port"])):
        if d_ref.validate():
            continue
        deps = {"ref": d_ref, "port": d_port}
        tables = {}
        for name in PK:
            m = reports[name].endpoints["m"].metrics
            roof = est[name].RooflineTerms(2.0 * 4.2e9 * 8, 8.4e9 + 1.07e9, 0.0, 1,
                                           chip=chips[name])
            tables[name] = [rep_mod[name].build_green_report(deps[name], **kw).table()
                            for kw in ({}, {"metrics": m}, {"roofline": roof},
                                       {"metrics": m, "roofline": roof, "tokens_per_step": 8})]
        assert tables["port"] == tables["ref"]
        n += 1
    assert n == 126


def test_quality_table_matches():
    tables = {}
    for name, q in (("ref", j_quality), ("port", t_quality)):
        rep = q.QualityReport(subject="s")
        for i, (quality, prov) in enumerate(zip(q.Quality, list(q.Provenance) * 3)):
            rep.add(quality, 1.25 * i + 1e-7, "u", prov, note=f"n{i}")
        tables[name] = (rep.table(), rep.get(q.Quality.USABILITY).value)
    assert tables["port"] == tables["ref"]


def _as_port_artifact(text: str) -> str:
    """The reference's artifact as the port writes it: torch in place of jax,
    repro_torch in place of repro."""
    return text.replace("install --no-cache-dir jax ", "install --no-cache-dir torch ") \
        .replace("repro.", "repro_torch.")


def test_container_artifacts_differ_only_in_framework_and_package():
    ref, port = _deployments(PK["ref"]), _deployments(PK["port"])
    for r, p in zip(ref, port):
        for fn in ("generate_dockerfile", "generate_oci_runtime_config", "generate_artifact"):
            want = getattr(j_container, fn)(r)
            got = getattr(t_container, fn)(p)
            assert got == _as_port_artifact(want), fn
            assert "jax" not in got and "repro." not in got
    for c in t_add.Containerization:
        assert dataclasses.asdict(t_container.overhead(c)) == dataclasses.asdict(
            j_container.overhead(j_add.Containerization(c.value)))
