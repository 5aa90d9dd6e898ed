"""The workload half of the chaos-search genome: mutable traffic knobs.

A searched chaos candidate is not just a fault schedule — the traffic
shape co-determines what a run exercises (a leader partition under heavy
skew starves different tenants than under uniform load; churn plus
backpressure opens retry paths a quiet trickle never touches). This module
names the :class:`~josefine_tpu.workload.model.WorkloadSpec` knobs the
search may mutate, their bounds, and the seeded mutation step — so the
genome surface lives WITH the workload model it parameterizes, and
``chaos/search.py`` stays a consumer of the catalog rather than a second
place that knows which knobs exist.

Every mutation product is clamped to :data:`KNOB_BOUNDS` and re-validated
through ``WorkloadSpec.validate()``: the searcher can never hand the soak
a spec the product drivers would reject.
"""

from __future__ import annotations

from josefine_tpu_torch.workload.model import WorkloadSpec

__all__ = ["KNOB_BOUNDS", "clamp_workload", "mutate_workload"]

#: knob -> (min, max, kind). The search mutates WITHIN these bounds; they
#: are soak-scale bounds (small clusters, short horizons), not product
#: limits — the bench axes go far beyond them.
KNOB_BOUNDS: dict[str, tuple[float, float, str]] = {
    # Tenant-count pressure: more tenants = more admission ledgers and a
    # longer Zipf tail mapped onto the same groups.
    "tenants": (2, 16, "int"),
    # Popularity skew: 0 = uniform, 3 = one-tenant hotspot.
    "skew": (0.0, 3.0, "float"),
    # Open-loop offered load, batches per virtual tick.
    "produce_per_tick": (0.5, 12.0, "float"),
    # Consumer-group churn cadence (0 = off).
    "churn_every_ticks": (0, 60, "int"),
    # Per-tenant inflight cap: small values turn offered load into queue
    # pressure and retries (the backpressure axis).
    "max_inflight_per_tenant": (1, 8, "int"),
}

#: Relative mutation magnitude for one knob step.
_STEP_FRAC = 0.5


def clamp_workload(knobs: dict) -> dict:
    """Clamp every known knob into bounds (unknown keys pass through —
    they are WorkloadSpec fields the genome does not mutate) and validate
    the result as a real spec."""
    out = dict(knobs)
    for name, (lo, hi, kind) in KNOB_BOUNDS.items():
        if name not in out:
            continue
        v = max(lo, min(hi, out[name]))
        out[name] = int(round(v)) if kind == "int" else float(v)
    WorkloadSpec(**out).validate()
    return out


def mutate_workload(knobs: dict, rng) -> tuple[dict, str]:
    """One seeded knob mutation: pick a knob, jitter it within bounds.
    Returns ``(new_knobs, description)`` — the description lands in the
    search log so a lineage's traffic history is readable."""
    name = rng.choice(sorted(KNOB_BOUNDS))
    lo, hi, kind = KNOB_BOUNDS[name]
    cur = knobs.get(name, WorkloadSpec.__dataclass_fields__[name].default)
    span = (hi - lo) * _STEP_FRAC
    if kind == "int":
        delta = rng.randint(1, max(1, int(span)))
        nxt = cur + (delta if rng.random() < 0.5 else -delta)
    else:
        nxt = cur + rng.uniform(-span, span)
    out = dict(knobs)
    out[name] = nxt
    out = clamp_workload(out)
    return out, f"{name}:{cur}->{out[name]}"
