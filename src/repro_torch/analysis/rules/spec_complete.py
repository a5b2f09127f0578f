"""R3 ``spec-roundtrip``: every declarative spec field must round-trip.

The ``ServingSpec`` API's whole value is that a deployment is *pure data*:
``to_json -> from_json`` must be lossless, validation must see every field,
and ``sweep`` must be able to address it.  Serialization is uniform
(``dataclasses.asdict``), but *de*serialization is not — ``from_dict``
reconstructs each nested spec class explicitly via ``_construct``, so adding
a spec-typed field without touching ``from_dict`` silently yields a raw dict
after a round-trip.  This rule makes that drift a lint error:

  * every field's annotation must be built from JSON-safe atoms (or a known
    spec class);
  * every spec class referenced by any field must be reconstructed with
    ``_construct(<Class>, ...)`` inside ``ServingSpec.from_dict``;
  * ``ServingSpec.to_dict`` must serialize via ``dataclasses.asdict`` (one
    uniform path — a hand-rolled dict would need per-field auditing);
  * every field must be *consumed* somewhere across the spec-defining
    modules (validation, ``problems()``, ``build()``, runtime wiring) —
    a field nothing reads is unvalidated, unswept drift.

The dynamic twin lives in ``tests/test_spec_roundtrip.py``.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterator, List, Set, Tuple

from repro_torch.analysis.context import FileContext
from repro_torch.analysis.findings import Finding

RULE = "spec-roundtrip"

# module (relative to the repro_torch package root) -> spec dataclasses defined there
_SPEC_MODULES = {
    "serving/api.py": ("SLOClass", "AutoscaleSpec", "EndpointSpec",
                       "ServingSpec"),
    "carbon/signal.py": ("CarbonSpec",),
    "carbon/shift.py": ("DeferralSpec",),
    "serving/admission/priority.py": ("PrioritySpec",),
    "serving/admission/disagg.py": ("DisaggSpec",),
    "workload/generators.py": ("WorkloadSpec",),
    "serving/regions/spec.py": ("RegionSpec",),
    "serving/chaos/spec.py": ("ChaosSpec", "ChaosEvent", "RetrySpec"),
    "serving/telemetry/spec.py": ("TelemetrySpec",),
    "serving/monitor/spec.py": ("MonitorSpec",),
    "serving/monitor/burnrate.py": ("BudgetSpec",),
}

_SPEC_CLASSES = {c for classes in _SPEC_MODULES.values() for c in classes}

# atoms a JSON document can carry losslessly (tuples re-tupled in
# __post_init__, spec classes re-constructed in from_dict)
_JSON_OK = {"Optional", "Tuple", "Dict", "List", "Mapping", "Sequence",
            "int", "float", "str", "bool", "None"} | _SPEC_CLASSES

_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def _annotation_str(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - pre-3.9 fallback
        return ""


def _class_fields(cls: ast.ClassDef) -> List[Tuple[str, str, int]]:
    """(field_name, annotation_source, line) for each dataclass field."""
    out = []
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target,
                                                          ast.Name):
            out.append((stmt.target.id, _annotation_str(stmt.annotation),
                        stmt.lineno))
    return out


def _usage_names(trees: List[ast.AST]) -> Set[str]:
    """Names consumed anywhere: attribute reads, keyword args, string keys."""
    used: Set[str] = set()
    for tree in trees:
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                used.add(node.attr)
            elif isinstance(node, ast.keyword) and node.arg:
                used.add(node.arg)
            elif isinstance(node, ast.Constant) and isinstance(node.value,
                                                               str):
                used.add(node.value)
    return used


def _constructed_in_from_dict(api_tree: ast.AST) -> Set[str]:
    """Class names passed to ``_construct`` inside ServingSpec.from_dict."""
    out: Set[str] = set()
    for node in ast.walk(api_tree):
        if isinstance(node, ast.ClassDef) and node.name == "ServingSpec":
            for fn in node.body:
                if isinstance(fn, ast.FunctionDef) \
                        and fn.name == "from_dict":
                    for call in ast.walk(fn):
                        if isinstance(call, ast.Call) \
                                and isinstance(call.func, ast.Name) \
                                and call.func.id == "_construct" \
                                and call.args \
                                and isinstance(call.args[0], ast.Name):
                            name = call.args[0].id
                            out.add("ServingSpec" if name == "cls" else name)
    return out


def _to_dict_uses_asdict(api_tree: ast.AST) -> bool:
    for node in ast.walk(api_tree):
        if isinstance(node, ast.ClassDef) and node.name == "ServingSpec":
            for fn in node.body:
                if isinstance(fn, ast.FunctionDef) and fn.name == "to_dict":
                    return any(
                        isinstance(c, ast.Call)
                        and ((isinstance(c.func, ast.Attribute)
                              and c.func.attr == "asdict")
                             or (isinstance(c.func, ast.Name)
                                 and c.func.id == "asdict"))
                        for c in ast.walk(fn))
    return False


def check(ctx: FileContext) -> Iterator[Finding]:
    # the whole cross-module analysis anchors on the API module
    if not ctx.is_file("repro_torch/serving/api.py"):
        return
    root = os.path.dirname(os.path.dirname(os.path.abspath(ctx.path)))
    trees: Dict[str, ast.AST] = {"serving/api.py": ctx.tree}
    for rel in _SPEC_MODULES:
        if rel in trees:
            continue
        full = os.path.join(root, *rel.split("/"))
        try:
            with open(full, encoding="utf-8") as fh:
                trees[rel] = ast.parse(fh.read(), filename=full)
        except (OSError, SyntaxError) as e:
            yield Finding(ctx.path, 1, 0, RULE,
                          f"cannot analyze spec module {rel}: {e}")
            return

    classes: Dict[str, Tuple[str, ast.ClassDef]] = {}
    for rel, tree in trees.items():
        wanted = set(_SPEC_MODULES[rel])
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and node.name in wanted:
                classes[node.name] = (rel, node)
    for name in sorted(_SPEC_CLASSES - set(classes)):
        yield Finding(ctx.path, 1, 0, RULE,
                      f"spec class {name} not found in its declared module")

    constructed = _constructed_in_from_dict(trees["serving/api.py"])
    used = _usage_names(list(trees.values()))
    if not _to_dict_uses_asdict(trees["serving/api.py"]):
        yield Finding(
            ctx.path, 1, 0, RULE,
            "ServingSpec.to_dict does not serialize via dataclasses.asdict; "
            "a hand-rolled dict will drift from the field set")

    needed_ctors: Dict[str, Tuple[str, int]] = {"ServingSpec": (ctx.path, 1)}
    for cls_name, (rel, node) in sorted(classes.items()):
        path = ctx.path if rel == "serving/api.py" else os.path.join(
            root, *rel.split("/"))
        for field, ann, line in _class_fields(node):
            tokens = set(_IDENT.findall(ann))
            bad = tokens - _JSON_OK
            if bad:
                yield Finding(
                    path, line, 0, RULE,
                    f"{cls_name}.{field}: annotation {ann!r} uses "
                    f"non-JSON-safe type(s) {sorted(bad)}; specs must be "
                    "built from JSON atoms and spec classes")
            for ref in tokens & _SPEC_CLASSES:
                needed_ctors.setdefault(ref, (path, line))
            if field not in used:
                yield Finding(
                    path, line, 0, RULE,
                    f"{cls_name}.{field} is never consumed by validation, "
                    "construction or runtime wiring across the spec "
                    "modules — dead fields are unvalidated drift")
    for ref, (path, line) in sorted(needed_ctors.items()):
        if ref not in constructed:
            yield Finding(
                path, line, 0, RULE,
                f"{ref} is never reconstructed in ServingSpec.from_dict "
                f"(_construct({ref}, ...) missing): a to_json -> from_json "
                "round-trip leaves it a raw dict")
