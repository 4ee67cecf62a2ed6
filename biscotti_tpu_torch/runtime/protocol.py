"""The port's copy of `biscotti_tpu/runtime/protocol.py`: the same feature
and message tables and the same `CURRENT_VERSION`.

Versioned protocol plane: ONE registry of every negotiated feature and
every RPC message type, with the version row each entered the protocol at.

Before this module the capability contract lived in two ad-hoc instances —
wire codecs (runtime/codecs.py) and trace stamping (telemetry/
tracectx.py) — each with its own copy of the legacy-hello reset
rule.  This module is now the single source of truth:

* ``FEATURES`` maps feature id -> the protocol version that introduced it.
  A peer advertises its feature set as extra tokens on the RegisterPeer
  hello's existing ``codecs`` list (old builds ignore unknown tokens and
  ``codecs.negotiate`` is all-or-raw64 over the *codec* stages only, so
  the extension is wire-compatible in both directions).
* ``MESSAGES`` maps every RPC message type -> (version, gating feature).
  The tier-1 protocol lint (tests/test_protocol_lint.py) asserts both
  tables cover the dispatch table in peer.py and docs/PROTOCOL.md —
  an unregistered frame evolution fails the suite.
* ``normalize_hello`` defines the legacy-hello reset semantics in exactly
  one place: a hello (or reply) without a well-formed capability list is
  a peer on a pre-negotiation build, and its grant collapses to
  ``LEGACY_CAPS`` (raw64 only).
* ``advertised(cfg)`` derives a config's advertised set, optionally
  pinned to a historical version row (``--protocol-version N`` = "old
  build" emulation for the mixed-version matrix and rolling upgrades).
* ``grant`` / ``degraded`` derive the per-peer negotiated set and the
  features lost against it (traced as ``feature_degraded{feature,peer}``
  and counted by the caller — see PeerAgent._record_caps).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, Optional, Sequence

from . import codecs as wcodecs

# Feature ids.  TRACE must stay equal to telemetry.tracectx.TRACE_CAP —
# guarded by tests so the two planes cannot drift apart.
RAW = wcodecs.RAW          # "raw64": the seed dialect, never negotiable away
TRACE = "trace"            # cross-peer span-context stamping
BUSY = "busy"              # structured admission busy-status replies
SNAPSHOT = "snapshot"      # pruned-chain snapshot bootstrap
RELAY = "relay"            # overlay relay/aggregate frames
PROTO = "proto"            # structured protocol-version advertisement
MIGRATE = "migrate"        # live-peer migration tickets (placement plane)
DKG = "dkg"                # dealerless genesis deal exchange (crypto/dkg.py)

# The grant of a peer on a pre-negotiation build (or a malformed hello).
LEGACY_CAPS: FrozenSet[str] = wcodecs.RAW_CAPS

# Metric family for features lost against a peer's advertised set
# (emitted by PeerAgent._record_caps; row in docs/OBSERVABILITY.md).
DEGRADED_METRIC = "biscotti_feature_degraded_total"
DEGRADED_HELP = ("features this node speaks that a peer's hello did not "
                 "grant (per feature, per peer; deduped per observed set)")


@dataclass(frozen=True)
class Feature:
    """One negotiated protocol feature: id + the version row it entered."""
    id: str
    version: int
    summary: str


@dataclass(frozen=True)
class Message:
    """One RPC message type: introduction version + gating feature.

    ``feature`` is empty for messages any build must serve; a non-empty
    feature means a peer whose own advertised set lacks it answers the
    message exactly like an old build: ``unknown method``.
    """
    name: str
    version: int
    feature: str
    summary: str


def _features(rows: Iterable[Feature]) -> Dict[str, Feature]:
    out: Dict[str, Feature] = {}
    for f in rows:
        if f.id in out:
            raise ValueError(f"duplicate feature id {f.id!r}")
        out[f.id] = f
    return out


FEATURES: Dict[str, Feature] = _features([
    Feature(RAW, 0, "seed base64 wire dialect (always granted)"),
    Feature("topk", 2, "top-k sparsification codec stage"),
    Feature("bf16", 2, "bfloat16 downcast codec stage"),
    Feature("f32", 2, "float32 downcast codec stage"),
    Feature("zlib", 2, "deflate codec stage"),
    Feature(wcodecs.CHUNK_CAP, 2, "chunked streaming of oversized frames"),
    Feature(BUSY, 3, "retryable busy-status shed replies"),
    Feature(SNAPSHOT, 4, "pruned-chain snapshot bootstrap for joiners"),
    Feature(RELAY, 5, "overlay relay + aggregated subtree intake"),
    Feature(TRACE, 6, "cross-peer trace-context stamping"),
    Feature(PROTO, 7, "structured protocol-version advertisement"),
    Feature(MIGRATE, 8, "live-peer migration ticket serving"),
    Feature(DKG, 8, "dealerless genesis deal exchange"),
])

MESSAGES: Dict[str, Message] = {m.name: m for m in [
    # --- version 0: the seed protocol -----------------------------------
    Message("RegisterPeer", 0, "", "membership hello; carries the capability list"),
    Message("RegisterBlock", 0, "", "full block push"),
    Message("AdvertiseBlock", 0, "", "block digest advertisement"),
    Message("GetBlock", 0, "", "block pull by iteration"),
    Message("RegisterUpdate", 0, "", "plain-mode worker update submission"),
    Message("RegisterSecret", 0, "", "secure-agg share submission"),
    Message("RegisterDecline", 0, "", "worker round decline"),
    Message("RequestNoise", 0, "", "peer noise-vector pull"),
    Message("VerifyUpdateKRUM", 0, "", "KRUM verification request"),
    Message("VerifyUpdateRONI", 0, "", "RONI verification request"),
    Message("GetUpdateList", 0, "", "miner accepted-update list pull"),
    Message("GetMinerPart", 0, "", "miner partial-aggregate pull"),
    # --- version 1: telemetry plane ------------------------------
    Message("Metrics", 1, "", "read-only metrics/trace-tail scrape"),
    # --- version 4: dynamic membership ---------------------------
    Message("GetSnapshot", 4, SNAPSHOT, "pruned-chain bootstrap pull"),
    Message("GetReshareDeal", 4, SNAPSHOT, "verifiable re-deal collection"),
    # --- version 5: aggregation overlay -------------------------
    Message("OverlayOffer", 5, RELAY, "subtree share hand-off to the relay"),
    Message("RegisterAggregate", 5, RELAY, "summed subtree intake at the miner"),
    Message("RelayFrames", 5, RELAY, "verbatim frame relay across one tree hop"),
    # --- version 8: elastic fleet plane (placement + genesis DKG) -------
    Message("GetMigrationTicket", 8, MIGRATE,
            "serialize a live peer for relocation (placement controller)"),
    Message("DkgDeal", 8, DKG,
            "Pedersen-committed genesis deal delivery/verification"),
]}

CURRENT_VERSION: int = max(
    max(f.version for f in FEATURES.values()),
    max(m.version for m in MESSAGES.values()),
)


def version_row(version: int) -> FrozenSet[str]:
    """Every feature available at ``version`` (the cumulative row)."""
    if not 0 <= version <= CURRENT_VERSION:
        raise ValueError(
            f"protocol version {version} outside [0, {CURRENT_VERSION}]")
    return frozenset(f.id for f in FEATURES.values() if f.version <= version)


def effective_version(cfg) -> int:
    """The version a config speaks: CURRENT unless pinned to an old row."""
    pin = getattr(cfg, "protocol_version", -1)
    return CURRENT_VERSION if pin < 0 else pin


def advertised(cfg) -> FrozenSet[str]:
    """The feature set a config advertises on its RegisterPeer hello.

    The version row caps what MAY be advertised; the config gates what
    IS: codec stages follow ``wire_codec``, trace follows ``cfg.trace``,
    relay follows ``cfg.overlay``.  busy/snapshot/proto are capability
    statements about the build, not the config, so they ride every row
    that contains them.
    """
    row = version_row(effective_version(cfg))
    out = {RAW}
    out |= wcodecs.capabilities(cfg.wire_codec) & row
    if getattr(cfg, "trace", False):
        out |= {TRACE} & row
    if getattr(cfg, "overlay", False):
        out |= {RELAY} & row
    out |= {BUSY, SNAPSHOT, PROTO, MIGRATE, DKG} & row
    return frozenset(out)


def normalize_hello(caps) -> FrozenSet[str]:
    """THE legacy-hello reset rule (one definition for every family).

    A well-formed capability list round-trips; anything else — absent
    key, None, scalar junk — is a peer on a pre-negotiation build and
    resets the grant to ``LEGACY_CAPS``.  A restarted legacy incarnation
    therefore stops receiving coded/stamped/relayed frames instead of
    breaking its link forever.
    """
    if isinstance(caps, (list, tuple, set, frozenset)):
        return frozenset(str(c) for c in caps)
    return LEGACY_CAPS


def grant(own: FrozenSet[str],
          recorded: Optional[FrozenSet[str]]) -> FrozenSet[str]:
    """The negotiated per-peer feature set: own ∩ theirs (raw64 floor).

    ``recorded is None`` means no hello yet — assume a legacy build.
    """
    if recorded is None:
        recorded = LEGACY_CAPS
    return (own & recorded) | {RAW}


def degraded(own: FrozenSet[str],
             recorded: Optional[FrozenSet[str]]) -> FrozenSet[str]:
    """Features this node speaks that the peer's hello did not grant."""
    return frozenset(own - grant(own, recorded) - {RAW})


def serves(own: FrozenSet[str], msg_type: str) -> bool:
    """Whether a build advertising ``own`` serves ``msg_type`` at all.

    Unregistered message types are served (the dispatch table is the
    authority for those — and the protocol lint fails the suite if one
    exists); feature-gated messages follow the own-build feature, so a
    ``--protocol-version`` pin answers them exactly like the old build:
    unknown method.
    """
    m = MESSAGES.get(msg_type)
    return m is None or not m.feature or m.feature in own


def snapshot(cfg, own: FrozenSet[str],
             degraded_by_peer: Dict[int, FrozenSet[str]]) -> dict:
    """The telemetry readout: version, advertised set, degradations."""
    return {
        "version": effective_version(cfg),
        "current": CURRENT_VERSION,
        "advertised": sorted(own),
        "degraded": {int(p): sorted(f)
                     for p, f in sorted(degraded_by_peer.items()) if f},
    }
