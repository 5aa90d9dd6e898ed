"""Journal-derived coverage signatures for chaos runs.

"From Consensus to Chaos" (arxiv 2601.00273) argues that Raft's interesting
failures must be *searched for*, which needs a scoring function: a stable,
seed-deterministic fingerprint of what a run actually exercised. The
flight-recorder timeline (:func:`josefine_tpu.utils.flight.merge_journals`)
is the substrate; this module distills it into a :class:`CoverageMap` — a
multiset of discrete *features* — whose :meth:`~CoverageMap.signature`
hashes the covered-feature set. Two same-seed soaks produce identical
signatures (pinned by tests/test_chaos_determinism.py); a nemesis search
driver scores a mutated schedule by how many features its run adds over
the corpus (:meth:`~CoverageMap.diff`).

Feature classes (the key's ``class:`` prefix):

* ``ev`` — event kinds observed at all (wire events refined by delivery
  path, e.g. ``msg_sent:routed``), the 1-gram floor so even a tiny run has
  coverage;
* ``kgram`` — distinct k-grams (default k=3) of the event-kind sequence
  *per group* (each group's subsequence of the merged timeline, so
  cross-node interleavings on one group count); the group id is NOT part
  of the key — coverage is about behavior shapes, not which row exhibited
  them;
* ``term_depth`` — the distinct per-group maximum terms reached (election
  churn depth);
* ``mode_flips`` — the active-set scheduler's compacted<->dense flip count
  per node, log2-bucketed;
* ``path_mix`` — the routed/host share of ``msg_sent`` traffic, bucketed
  to deciles (only present when wire tracing ran);
* ``snap_ctx`` — each ``snapshot_install``'s neighbors in its group's
  event sequence (what the install interleaved with);
* ``snap_under_partition`` — a snapshot installed while the fault plane
  held a partition/blocked link/crash open (needs the plane's fault
  events; tick comparison is engine-tick vs plane-tick, which the lockstep
  harness keeps aligned for live nodes — a coverage signal, not a proof).

Wire-plane classes (:meth:`CoverageMap.from_wire_events`, distilled from a
:class:`josefine_tpu.chaos.wire.WirePlane` journal — the scoring substrate
for wire-mode chaos search):

* ``wev`` — wire fate kinds observed at all (``conn_reset``,
  ``torn_write``, ``conn_stall``, ``conn_refused``, ``conn_open``);
* ``wconn`` — fate kinds per connection CLASS (client ``c``, server ``s``,
  accept path) — a reset on the broker side is different coverage from one
  on the client side;
* ``wkgram`` — distinct k-grams of each connection's fate sequence
  (connection identity is not part of the key — shapes, not labels);
* ``wretry`` / ``wrestart`` — log2-bucketed client retry and
  consumer-group restart totals (how hard the resilience machinery
  actually worked).

Everything is derived from data the run already produced; nothing here
touches the engine hot path.
"""

from __future__ import annotations

import hashlib

from josefine_tpu_torch.utils.metrics import REGISTRY

__all__ = ["CoverageMap", "corpus_coverage", "corpus_entry_filename",
           "load_corpus_entries", "save_corpus_entry"]

_WIRE_KINDS = ("msg_sent", "msg_delivered")

# Fault-plane event kinds that open / close a "disturbed" window for the
# snap_under_partition feature (see module docstring).
_DISTURB_OPEN = ("link_blocked", "node_crashed")
_DISTURB_CLOSE = ("link_healed", "node_restarted")

_m_features = REGISTRY.gauge(
    "chaos_coverage_features",
    "Distinct journal-derived coverage features per class "
    "(utils/coverage.CoverageMap; set at publish time)")


def _refined_kind(ev: dict) -> str:
    """Event kind, with wire events refined by their delivery path — a
    routed heartbeat and a host-decoded one are different coverage."""
    kind = ev.get("kind", "?")
    if kind in _WIRE_KINDS:
        path = (ev.get("detail") or {}).get("path", "?")
        return f"{kind}:{path}"
    return kind


def _log2_bucket(n: int) -> int:
    """Largest power of two <= n (n >= 1) — the coarse count bucket."""
    return 1 << (int(n).bit_length() - 1)


def _disturbed_intervals(fault_events) -> list[tuple[int, int]]:
    """[(start, end)] virtual-tick windows where the fault plane held any
    partition/blocked link/crash open. ``partition`` events expand to their
    cross links (the plane blocks links directly without per-link events);
    ``heal_all`` closes every link window at once."""
    open_keys: set = set()
    intervals: list[tuple[int, int]] = []
    start = None
    for ev in fault_events or ():
        tick = int(ev.get("tick", 0))
        kind = ev.get("kind")
        if kind == "partition":
            sym = ev.get("symmetric", True)
            for a in ev.get("a", ()):
                for b in ev.get("b", ()):
                    if a == b:
                        continue
                    open_keys.add(("l", a, b))
                    if sym:
                        open_keys.add(("l", b, a))
        elif kind in _DISTURB_OPEN:
            if kind == "link_blocked":
                open_keys.add(("l", ev.get("src"), ev.get("dst")))
            else:
                open_keys.add(("n", ev.get("node")))
        elif kind in _DISTURB_CLOSE:
            if kind == "link_healed":
                open_keys.discard(("l", ev.get("src"), ev.get("dst")))
            else:
                open_keys.discard(("n", ev.get("node")))
        elif kind == "heal_all":
            open_keys = {k for k in open_keys if k[0] != "l"}
        else:
            continue
        if open_keys and start is None:
            start = tick
        elif not open_keys and start is not None:
            intervals.append((start, tick))
            start = None
    if start is not None:
        intervals.append((start, 1 << 62))  # never healed: open-ended
    return intervals


class CoverageMap:
    """A multiset of coverage features with merge/diff algebra and a
    stable signature (see module docstring)."""

    def __init__(self, counts: dict[str, int] | None = None):
        self.counts: dict[str, int] = dict(counts or {})

    # ------------------------------------------------------------ builders

    def add(self, feature: str, n: int = 1) -> None:
        self.counts[feature] = self.counts.get(feature, 0) + n

    @classmethod
    def from_timeline(cls, timeline, k: int = 3,
                      fault_events=None) -> "CoverageMap":
        """Distill a merged timeline (list of event dicts, as
        :func:`~josefine_tpu.utils.flight.merge_journals` returns) into a
        coverage map. ``fault_events`` is the fault plane's structured
        event list (``FaultPlane.events``), enabling the
        ``snap_under_partition`` class."""
        cov = cls()
        group_seqs: dict[int, list[str]] = {}
        snap_ticks: list[int] = []
        flips_per_node: dict[str, int] = {}
        sent_paths: dict[str, int] = {}
        max_term: dict[int, int] = {}
        for ev in timeline:
            kind = _refined_kind(ev)
            cov.add(f"ev:{kind}")
            g = int(ev.get("group", -1))
            if g >= 0:
                group_seqs.setdefault(g, []).append(kind)
                t = int(ev.get("term", -1))
                if t > max_term.get(g, 0):
                    max_term[g] = t
            raw = ev.get("kind")
            if raw == "snapshot_install":
                snap_ticks.append(int(ev.get("tick", 0)))
            elif raw == "active_mode_flip":
                node = str(ev.get("node", "?"))
                flips_per_node[node] = flips_per_node.get(node, 0) + 1
            elif raw == "msg_sent":
                path = (ev.get("detail") or {}).get("path", "?")
                sent_paths[path] = sent_paths.get(path, 0) + 1
        for seq in group_seqs.values():
            for i in range(len(seq) - k + 1):
                cov.add("kgram:" + ">".join(seq[i:i + k]))
            for i, kind in enumerate(seq):
                if kind == "snapshot_install":
                    prev = seq[i - 1] if i > 0 else "-"
                    nxt = seq[i + 1] if i + 1 < len(seq) else "-"
                    cov.add(f"snap_ctx:{prev}>{nxt}")
        for depth in sorted(set(max_term.values())):
            if depth > 0:
                cov.add(f"term_depth:{depth}")
        for count in flips_per_node.values():
            cov.add(f"mode_flips:{_log2_bucket(count)}")
        total_sent = sum(sent_paths.values())
        if total_sent:
            frac = sent_paths.get("routed", 0) / total_sent
            cov.add(f"path_mix:{int(frac * 10)}")
        if snap_ticks and fault_events:
            ivs = _disturbed_intervals(fault_events)
            hits = sum(1 for t in snap_ticks
                       if any(a <= t <= b for a, b in ivs))
            if hits:
                cov.add("snap_under_partition:1", hits)
        return cov

    @classmethod
    def from_wire_events(cls, events, k: int = 3, retries: int = 0,
                         group_restarts: int = 0) -> "CoverageMap":
        """Distill a wire plane's connection journals (``WirePlane.events()``)
        into wire-class coverage (see module docstring)."""
        cov = cls()
        per_conn: dict[str, list[str]] = {}
        for ev in events:
            kind = ev.get("kind", "?")
            label = str(ev.get("conn", "?"))
            # Connection class: the label prefix with node ordinals
            # stripped ("c" client, "s" server, "accept" accept path).
            prefix = "".join(ch for ch in label.split(":", 1)[0]
                             if not ch.isdigit()) or "?"
            cov.add(f"wev:{kind}")
            cov.add(f"wconn:{prefix}:{kind}")
            per_conn.setdefault(label, []).append(kind)
        for seq in per_conn.values():
            for i in range(len(seq) - k + 1):
                cov.add("wkgram:" + ">".join(seq[i:i + k]))
        if retries > 0:
            cov.add(f"wretry:{_log2_bucket(retries)}")
        if group_restarts > 0:
            cov.add(f"wrestart:{_log2_bucket(group_restarts)}")
        return cov

    # ------------------------------------------------------------- algebra

    def merge(self, other: "CoverageMap") -> "CoverageMap":
        """Union of the feature sets, counts summed (the corpus fold)."""
        out = CoverageMap(self.counts)
        for feat, n in other.counts.items():
            out.add(feat, n)
        return out

    def diff(self, other: "CoverageMap") -> "CoverageMap":
        """Features THIS map covers that ``other`` does not (the novelty a
        candidate run adds over the corpus), with this map's counts."""
        return CoverageMap({feat: n for feat, n in self.counts.items()
                            if feat not in other.counts})

    def novelty(self, corpus: "CoverageMap") -> int:
        """The search driver's score: how many DISTINCT features this run
        covered that the corpus has never seen (``len(self.diff(corpus))``
        without building the intermediate map)."""
        return sum(1 for feat in self.counts if feat not in corpus.counts)

    def __len__(self) -> int:
        return len(self.counts)

    def __eq__(self, other) -> bool:
        return (isinstance(other, CoverageMap)
                and self.counts == other.counts)

    # ------------------------------------------------------------ exposition

    def signature(self) -> str:
        """Stable hex fingerprint of the COVERED set (keys only — two runs
        that covered the same behaviors sign identically regardless of how
        often each fired). Empty map -> empty string, so "non-empty
        signature" means "this run covered something"."""
        if not self.counts:
            return ""
        h = hashlib.sha256()
        for feat in sorted(self.counts):
            h.update(feat.encode())
            h.update(b"\n")
        return h.hexdigest()

    def class_counts(self) -> dict[str, int]:
        """Distinct features per class (the ``class:`` key prefix)."""
        out: dict[str, int] = {}
        for feat in self.counts:
            cls = feat.split(":", 1)[0]
            out[cls] = out.get(cls, 0) + 1
        return dict(sorted(out.items()))

    def publish(self, node: int | None = None) -> None:
        """Expose the per-class distinct-feature counts as the
        ``chaos_coverage_features{class=...}`` Prometheus gauge (node-scoped
        when ``node`` is given, like every engine series). Publishing
        REPLACES this scope's prior series: the registry is process-global,
        and a later soak that covered fewer classes must not keep reporting
        an earlier run's — a stale path_mix gauge would claim wire coverage
        a run never produced."""
        vals = _m_features.values
        for key in [k for k in vals if dict(k).get("node") == node]:
            del vals[key]
        for cls, n in self.class_counts().items():
            # "class" is a Python keyword, hence the dict splat.
            labels = {"class": cls}
            if node is not None:
                labels["node"] = node
            _m_features.set(n, **labels)

    def to_dict(self) -> dict:
        return {
            "signature": self.signature(),
            "features": len(self.counts),
            "class_counts": self.class_counts(),
            "counts": dict(sorted(self.counts.items())),
        }

    @classmethod
    def from_dict(cls, data: dict) -> "CoverageMap":
        return cls(data.get("counts") or {})


# ----------------------------------------------------------- corpus storage
#
# The chaos-search corpus (tests/fixtures/chaos_corpus/ and any --corpus
# dir) is a directory of one-JSON-file-per-entry records:
#
#   {"name", "schedule": <DSL dict>, "workload": <knobs|null>, "seed",
#    "signature", "class_counts", "features": [keys...], "origin",
#    "iteration", "parent"}
#
# ``features`` holds the entry's covered-feature KEYS (not counts): enough
# to rebuild the corpus union exactly without re-running any soak, which is
# what makes the corpus resumable — a fresh search process loads the
# directory and scores novelty against the same union the previous run
# ended with. Filenames embed the signature prefix so entries are
# content-addressed and a directory listing is deterministic.

def corpus_entry_filename(entry: dict) -> str:
    """Deterministic, content-addressed entry filename."""
    sig = entry.get("signature") or "empty"
    return f"entry_{sig[:16]}.json"


def save_corpus_entry(dirpath: str, entry: dict) -> str:
    """Write one corpus entry (sorted keys — byte-stable); returns the
    path. Overwrites a same-signature entry (content-addressed)."""
    import json
    import os

    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(dirpath, corpus_entry_filename(entry))
    with open(path, "w") as fh:
        json.dump(entry, fh, sort_keys=True, indent=1)
        fh.write("\n")
    return path


def load_corpus_entries(dirpath: str) -> list[dict]:
    """Load every ``entry_*.json`` in a corpus directory, sorted by
    filename (deterministic iteration order for scoring and parent
    selection). A missing directory is an empty corpus."""
    import json
    import os

    if not os.path.isdir(dirpath):
        return []
    out = []
    for name in sorted(os.listdir(dirpath)):
        if name.startswith("entry_") and name.endswith(".json"):
            with open(os.path.join(dirpath, name)) as fh:
                out.append(json.load(fh))
    return out


def corpus_coverage(entries) -> CoverageMap:
    """The corpus union: one CoverageMap covering every feature any entry
    covered (counts = how many entries cover the feature — the fold a
    candidate's ``novelty()`` is scored against)."""
    cov = CoverageMap()
    for e in entries:
        for feat in e.get("features", ()):
            cov.add(feat)
    return cov
