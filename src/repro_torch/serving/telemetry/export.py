"""Perfetto export, trace schema validation, and the phase-breakdown table.

The exporter turns a :class:`~repro_torch.serving.telemetry.recorder.TraceRecorder`
into Chrome/Perfetto ``trace_event`` JSON (open it at https://ui.perfetto.dev
or ``chrome://tracing``):

  * one **process** per endpoint, one **thread** per replica; the fleet's
    router/autoscaler instants live on pid 0;
  * every meter billing event becomes a matched ``B``/``E`` duration span,
    colored by its energy bucket (``cname``) and carrying the exact joules,
    grams, watts and residency in ``args`` — preemption sub-dispatches nest
    inside the interrupted window like call frames;
  * request lifecycles are nestable **async** spans (``b``/``e``) —
    ``request`` wrapping ``queue_wait -> prefill -> decode`` — one async id
    per lifecycle record, so a crashed-then-retried request shows both
    attempts; deferral holds are their own async track;
  * :class:`MetricsRegistry` gauges export as ``C`` counters, plus derived
    per-replica ``power_w`` / ``batch_occupancy`` counters stepped at each
    billing boundary.

Timestamps are **integer microseconds of virtual time** (the simulator's
clock, not the host's), globally sorted, so the validator can demand
monotone ``ts`` and per-track stack discipline — ``validate_trace`` is the
schema check CI runs on the exported artifact.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from repro_torch.serving.telemetry.recorder import FLEET_PID, TraceRecorder

# Chrome reserved color names per energy bucket (the span palette)
_COLORS = {"active": "good", "idle": "grey", "preempt": "bad",
           "xfer": "yellow", "lost": "terrible"}

PHASES = ("queue_wait", "prefill", "xfer", "decode", "preempted")


def _us(t_s: float) -> int:
    return int(round(t_s * 1e6))


def _pct(sorted_vals: Sequence[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(int(round(q * (len(sorted_vals) - 1))),
                           len(sorted_vals) - 1)]


def to_perfetto(rec: TraceRecorder) -> dict:
    """Lossless export of everything the recorder holds."""
    out: List[dict] = []

    # -- track metadata -------------------------------------------------------
    # Sort indices pin the UI layout regardless of pid/tid allocation order:
    # the fleet process first, then endpoints alphabetically; within a
    # process the router/anchor thread first, then replicas alphabetically.
    meta: List[dict] = [
        {"ph": "M", "pid": FLEET_PID, "tid": 0, "name": "process_name",
         "args": {"name": "fleet"}},
        {"ph": "M", "pid": FLEET_PID, "tid": 0, "name": "process_sort_index",
         "args": {"sort_index": 0}},
        {"ph": "M", "pid": FLEET_PID, "tid": 0, "name": "thread_name",
         "args": {"name": "router"}},
        {"ph": "M", "pid": FLEET_PID, "tid": 0, "name": "thread_sort_index",
         "args": {"sort_index": 0}},
    ]
    for rank, (endpoint, pid) in enumerate(sorted(rec._pids.items()), 1):
        meta.append({"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                     "args": {"name": endpoint}})
        meta.append({"ph": "M", "pid": pid, "tid": 0,
                     "name": "process_sort_index",
                     "args": {"sort_index": rank}})
    threads_by_pid: Dict[int, List[tuple]] = {}
    for (endpoint, replica), tid in rec._tids.items():
        threads_by_pid.setdefault(rec._pids[endpoint], []).append(
            (replica, tid))
    for pid in sorted(threads_by_pid):
        for rank, (replica, tid) in enumerate(sorted(threads_by_pid[pid]), 1):
            meta.append({"ph": "M", "pid": pid, "tid": tid,
                         "name": "thread_name", "args": {"name": replica}})
            meta.append({"ph": "M", "pid": pid, "tid": tid,
                         "name": "thread_sort_index",
                         "args": {"sort_index": rank}})

    # -- replica energy spans: stack-valid B/E per (pid, tid) -----------------
    spans_by_track: Dict[tuple, List[tuple]] = {}
    for i, ev in enumerate(rec.events):
        if ev[0] == "span":
            _, pid, tid, kind, t0, dur, j, g, n, tokens = ev
            spans_by_track.setdefault((pid, tid), []).append(
                (t0, dur, i, kind, j, g, n, tokens))
        elif ev[0] == "inst":
            _, pid, tid, name, t, args = ev
            out.append({"ph": "i", "pid": pid, "tid": tid, "name": name,
                        "ts": _us(t), "s": "t", "args": args})
        elif ev[0] == "ctr":
            _, pid, tid, series, t, v = ev
            out.append({"ph": "C", "pid": pid, "tid": tid, "name": series,
                        "ts": _us(t), "args": {"value": v}})

    for (pid, tid), spans in spans_by_track.items():
        # earliest-start first; at a tie the longer span is the parent
        spans.sort(key=lambda s: (s[0], -s[1], s[2]))
        stack: List[int] = []  # open span end-times (us)
        for t0, dur, _, kind, j, g, n, tokens in spans:
            b = _us(t0)
            e = max(_us(t0 + dur), b)
            while stack and stack[-1] <= b:
                out.append({"ph": "E", "pid": pid, "tid": tid,
                            "ts": stack.pop()})
            if stack and e > stack[-1]:
                e = stack[-1]  # float residue: nest inside the parent
            args = {"j": j, "g": g,
                    "power_w": (j / dur if dur > 0 else 0.0)}
            if kind == "active":
                args["n_resident"] = n
                args["tokens"] = tokens
            out.append({"ph": "B", "pid": pid, "tid": tid, "name": kind,
                        "cat": "energy", "ts": b,
                        "cname": _COLORS.get(kind, "grey"), "args": args})
            if rec.metrics is not None:
                out.append({"ph": "C", "pid": pid, "tid": tid,
                            "name": "power_w", "ts": b,
                            "args": {"value": args["power_w"]}})
                out.append({"ph": "C", "pid": pid, "tid": tid,
                            "name": "power_w", "ts": e, "args": {"value": 0.0}})
                if kind == "active":
                    out.append({"ph": "C", "pid": pid, "tid": tid,
                                "name": "batch_occupancy", "ts": b,
                                "args": {"value": float(n)}})
                    out.append({"ph": "C", "pid": pid, "tid": tid,
                                "name": "batch_occupancy", "ts": e,
                                "args": {"value": 0.0}})
            stack.append(e)
        while stack:
            out.append({"ph": "E", "pid": pid, "tid": tid, "ts": stack.pop()})

    # -- request lifecycles: nestable async spans, one id per record ----------
    for i, (pid, tid, rid, cls, arr, start, first, done,
            pre) in enumerate(rec.requests):
        aid = str(i + 1)
        start = max(start, arr)
        first = max(first, start)
        done = max(done, first)
        root_args = {"rid": rid, "class": cls}
        if rid in rec.request_j:
            root_args["j"] = rec.request_j[rid]
            root_args["g"] = rec.request_g.get(rid, 0.0)
        out.append({"ph": "b", "cat": "request", "id": aid, "pid": pid,
                    "tid": tid, "name": "request", "ts": _us(arr),
                    "args": root_args})
        for name, a, b_ in (("queue_wait", arr, start),
                            ("prefill", start, first),
                            ("decode", first, done)):
            args = {"rid": rid}
            if name == "decode" and pre > 0:
                args["preempted_s"] = pre
            out.append({"ph": "b", "cat": "request", "id": aid, "pid": pid,
                        "tid": tid, "name": name, "ts": _us(a), "args": args})
            out.append({"ph": "e", "cat": "request", "id": aid, "pid": pid,
                        "tid": tid, "name": name, "ts": max(_us(b_), _us(a))})
        out.append({"ph": "e", "cat": "request", "id": aid, "pid": pid,
                    "tid": tid, "name": "request", "ts": _us(done)})

    # -- deferral holds -------------------------------------------------------
    for i, (rid, arr, rel, args) in enumerate(rec.holds):
        aid = f"h{i + 1}"
        out.append({"ph": "b", "cat": "deferral", "id": aid, "pid": FLEET_PID,
                    "tid": 0, "name": "deferral_hold", "ts": _us(arr),
                    "args": dict(args, rid=rid)})
        out.append({"ph": "e", "cat": "deferral", "id": aid, "pid": FLEET_PID,
                    "tid": 0, "name": "deferral_hold",
                    "ts": max(_us(rel), _us(arr))})

    # stable sort: within one ts the per-track generation order (which is
    # stack-valid by construction) is preserved
    out.sort(key=lambda e: e["ts"])
    return {
        "traceEvents": meta + out,
        "displayTimeUnit": "ms",
        "otherData": {
            "clock": "virtual",
            "time_unit": "us",
            "dropped_events": rec.dropped,
        },
    }


def validate_trace(doc: dict) -> List[str]:
    """Schema check for an exported trace; returns problems (empty = valid).

    Demands: monotone ``ts`` across the stream, int ``pid``/``tid`` on every
    event, ``B``/``E`` stack discipline per (pid, tid) with matching names,
    ``b``/``e`` async pairing per (cat, id), ``thread_name`` metadata for
    every track that carries duration spans, and deterministic layout
    metadata: every named process carries an integer ``process_sort_index``
    (unique per pid), every named thread an integer ``thread_sort_index``
    (unique within its pid).
    """
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    named_tracks = set()
    named_pids = set()
    proc_sort: Dict[int, int] = {}
    thread_sort: Dict[tuple, int] = {}
    for i, ev in enumerate(events):
        if ev.get("ph") != "M":
            continue
        name = ev.get("name")
        if name == "thread_name":
            named_tracks.add((ev.get("pid"), ev.get("tid")))
        elif name == "process_name":
            named_pids.add(ev.get("pid"))
        elif name in ("process_sort_index", "thread_sort_index"):
            idx = (ev.get("args") or {}).get("sort_index")
            if not isinstance(idx, int):
                problems.append(
                    f"event {i}: {name} without integer sort_index")
                continue
            if name == "process_sort_index":
                prev = proc_sort.setdefault(ev.get("pid"), idx)
                if prev != idx:
                    problems.append(
                        f"event {i}: conflicting process_sort_index for "
                        f"pid {ev.get('pid')} ({prev} vs {idx})")
            else:
                key = (ev.get("pid"), ev.get("tid"))
                prev = thread_sort.setdefault(key, idx)
                if prev != idx:
                    problems.append(
                        f"event {i}: conflicting thread_sort_index for "
                        f"{key} ({prev} vs {idx})")
    for pid in sorted(named_pids - set(proc_sort), key=repr):
        problems.append(f"process {pid} has process_name but no "
                        "process_sort_index (layout is non-deterministic)")
    for track in sorted(named_tracks - set(thread_sort), key=repr):
        problems.append(f"thread {track} has thread_name but no "
                        "thread_sort_index (layout is non-deterministic)")
    by_pid: Dict[int, List[int]] = {}
    for (pid, _tid), idx in thread_sort.items():
        by_pid.setdefault(pid, []).append(idx)
    for pid, idxs in sorted(by_pid.items(), key=lambda kv: repr(kv[0])):
        if len(idxs) != len(set(idxs)):
            problems.append(
                f"duplicate thread_sort_index values within pid {pid}")
    if len(set(proc_sort.values())) != len(proc_sort):
        problems.append("duplicate process_sort_index values across pids")
    prev_ts = None
    dur_stacks: Dict[tuple, List[str]] = {}
    async_stacks: Dict[tuple, List[str]] = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph == "M":
            continue
        pid, tid, ts = ev.get("pid"), ev.get("tid"), ev.get("ts")
        if not isinstance(pid, int) or not isinstance(tid, int):
            problems.append(f"event {i}: non-integer pid/tid ({pid}, {tid})")
            continue
        if not isinstance(ts, int):
            problems.append(f"event {i}: non-integer ts {ts!r}")
            continue
        if prev_ts is not None and ts < prev_ts:
            problems.append(f"event {i}: ts {ts} < previous {prev_ts}")
        prev_ts = ts
        if ph == "B":
            if (pid, tid) not in named_tracks:
                problems.append(
                    f"event {i}: span on unnamed track ({pid}, {tid})")
            dur_stacks.setdefault((pid, tid), []).append(ev.get("name", ""))
        elif ph == "E":
            stack = dur_stacks.get((pid, tid), [])
            if not stack:
                problems.append(f"event {i}: E without open B on "
                                f"({pid}, {tid})")
            else:
                opened = stack.pop()
                if "name" in ev and ev["name"] != opened:
                    problems.append(f"event {i}: E({ev['name']}) closes "
                                    f"B({opened})")
        elif ph == "b":
            async_stacks.setdefault((ev.get("cat"), ev.get("id")),
                                    []).append(ev.get("name", ""))
        elif ph == "e":
            stack = async_stacks.get((ev.get("cat"), ev.get("id")), [])
            if not stack:
                problems.append(f"event {i}: async e without b "
                                f"(cat={ev.get('cat')}, id={ev.get('id')})")
            elif stack.pop() != ev.get("name", ""):
                problems.append(f"event {i}: async e name mismatch")
        elif ph == "C":
            v = (ev.get("args") or {}).get("value")
            if not isinstance(v, (int, float)):
                problems.append(f"event {i}: counter without numeric value")
        elif ph != "i":
            problems.append(f"event {i}: unknown phase {ph!r}")
    for (pid, tid), stack in dur_stacks.items():
        if stack:
            problems.append(f"unclosed B spans {stack} on ({pid}, {tid})")
    for key, stack in async_stacks.items():
        if stack:
            problems.append(f"unclosed async spans {stack} for {key}")
    return problems


def write_trace(path: str, rec: TraceRecorder) -> dict:
    doc = to_perfetto(rec)
    with open(path, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
    return doc


def phase_breakdown(responses, preempt_by_rid: Optional[Dict] = None,
                    xfer_by_rid: Optional[Dict] = None) -> dict:
    """Per-SLO-class ``queue_wait/prefill/xfer/decode/preempted`` table.

    Built from the *final* responses (post transit-shift, post disagg
    stitching) so the phase sums line up with the latencies the report
    quotes.  For a disaggregated request the decode-pool queueing between
    KV arrival and decode dispatch is folded into ``decode`` (the stitched
    response does not expose that boundary); ``xfer`` is the billed handoff
    plus region-transit time for the request.
    """
    pre = preempt_by_rid or {}
    xf = xfer_by_rid or {}
    by_cls: Dict[str, Dict[str, List[float]]] = {}
    for r in responses:
        cls = getattr(r, "priority", None) or "standard"
        d = by_cls.setdefault(cls, {ph: [] for ph in PHASES})
        p = pre.get(r.rid, 0.0)
        x = xf.get(r.rid, 0.0)
        d["queue_wait"].append(max(r.start_s - r.arrival_s, 0.0))
        d["prefill"].append(max(r.first_token_s - r.start_s, 0.0))
        d["xfer"].append(x)
        d["decode"].append(max(r.done_s - r.first_token_s - x - p, 0.0))
        d["preempted"].append(p)
    out: Dict[str, dict] = {}
    for cls, phases in sorted(by_cls.items()):
        out[cls] = {}
        for ph in PHASES:
            vals = sorted(phases[ph])
            n = len(vals)
            out[cls][ph] = {
                "n": n,
                "mean_s": (sum(vals) / n) if n else 0.0,
                "p50_s": _pct(vals, 0.50),
                "p95_s": _pct(vals, 0.95),
            }
    return out
