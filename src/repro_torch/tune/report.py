"""Sweep reporting: the winning ServeConfig as a loadable artifact,
plus the per-parameter sensitivity table (DESIGN.md §19).

The tuner's product is not a number, it is a *deployable config*:
:func:`emit_serve_config` writes ``{format, max_distance, serve_config,
meta}`` as JSON and ``launch/serve.py --config`` loads it back through
:func:`load_serve_config` (round-trip pinned by tests/test_tune.py).
``serve_config`` serializes through ``ServeConfig.to_json_dict`` /
``from_json_dict``, so unknown fields fail loudly instead of silently
reverting a knob to its default. The artifact format is the JAX
package's, so an artifact either package wrote loads in the other; the
one field the port drops is ``use_pallas`` (:data:`DROPPED_FIELDS`).

:func:`sensitivity_table` answers "which knob mattered": for every
sweep axis it groups the scored candidates by axis value and reports
the best score per value; the spread between the best and worst value
of one axis is that axis's leverage under this workload (an axis with
near-zero spread can be dropped from the next sweep).
"""

from __future__ import annotations

import json

from repro_torch.serving import ServeConfig

SERVE_CONFIG_FORMAT = "repro.tune/serve_config.v1"  # shared with the JAX package


def emit_serve_config(path: str, max_distance: int, config: ServeConfig, *,
                      meta: dict | None = None) -> dict:
    """Write the winning (MaxDistance, ServeConfig) pair as the JSON
    artifact ``launch/serve.py --config`` consumes. Returns the
    payload (benches embed it in their report)."""
    payload = {
        "format": SERVE_CONFIG_FORMAT,
        "max_distance": int(max_distance),
        "serve_config": config.to_json_dict(),
        "meta": meta or {},
    }
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
    return payload


# the JAX package's switch between its Pallas and lax window joins; the
# port always runs its CUDA kernel on a card, so the knob means nothing here
DROPPED_FIELDS = ("use_pallas",)


def load_serve_config(path: str) -> tuple[int, ServeConfig, dict]:
    """Load an emitted config artifact: ``(max_distance, ServeConfig,
    meta)``. Rejects files that are not serve-config artifacts and
    configs with unknown fields (``ServeConfig.from_json_dict``), except
    :data:`DROPPED_FIELDS`, which are dropped and listed with their values
    under ``meta["dropped_fields"]``."""
    with open(path) as fh:
        payload = json.load(fh)
    fmt = payload.get("format")
    if fmt != SERVE_CONFIG_FORMAT:
        raise ValueError(f"{path}: not a tuned serve config "
                         f"(format={fmt!r}, want {SERVE_CONFIG_FORMAT!r})")
    data = dict(payload["serve_config"])
    dropped = {k: data.pop(k) for k in DROPPED_FIELDS if k in data}
    cfg = ServeConfig.from_json_dict(data)
    meta = dict(payload.get("meta", {}))
    if dropped:
        meta["dropped_fields"] = dropped
    return int(payload["max_distance"]), cfg, meta


def sensitivity_table(scored) -> dict:
    """Per-axis sensitivity from scored candidates.

    ``scored`` is ``[(Candidate, score), ...]`` (typically the sweep's
    rung-0 history: full grid coverage). Returns, per axis (including
    ``max_distance``), the best score observed at each axis value plus
    the axis ``spread`` (worst best-per-value minus best best-per-value
    — how much picking this knob wrong costs when everything else is
    chosen well)."""
    best: dict[str, dict[str, float]] = {}
    counts: dict[str, dict[str, int]] = {}
    for cand, score in scored:
        axes = (("max_distance", cand.max_distance),) + tuple(
            cand.axis_values or cand.overrides)
        for axis, value in axes:
            label = str(value)
            b = best.setdefault(axis, {})
            prev = b.get(label)
            if prev is None or score < prev:
                b[label] = float(score)
            c = counts.setdefault(axis, {})
            c[label] = c.get(label, 0) + 1
    out: dict = {}
    for axis, by_value in sorted(best.items()):
        vals = sorted(by_value.items(), key=lambda kv: kv[1])
        out[axis] = {
            "values": {label: {"best_score": s,
                               "n": counts[axis][label]}
                       for label, s in vals},
            "best_value": vals[0][0],
            "spread": vals[-1][1] - vals[0][1],
        }
    return out
