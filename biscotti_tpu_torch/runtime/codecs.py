"""The port's copy of `biscotti_tpu/runtime/codecs.py`, byte for byte the
same codecs. `transform` stays numpy: its top-k is `np.argpartition`,
whose tie set `torch.topk` does not reproduce, and bf16 rounding stays
the bit formula below (`tensor.to(torch.bfloat16)` differs on NaN
payloads and near FLT_MAX).

Wire data plane: negotiated per-payload array codecs.

Biscotti's cost is communication-dominated: every round gossips per-peer
deltas, noise vectors and full blocks (global weights + accepted updates)
to N peers, and the seed runtime shipped all of it as raw float64
("Secure Distributed Training at Scale" and NET-SA, PAPERS.md, both
identify exactly this traffic as the scaling bottleneck). This module is
the codec half of the fix; `messages.py` owns the frame format that
carries the coded buffers and `rpc.py` reassembles chunked frames.

Two planes, one hard invariant:

  * **Protocol plane — explicitly lossy, before commitment.**
    `WireCodec.transform()` projects a worker's delta onto the codec's
    representable set (top-k sparsification with error-feedback
    residuals, f32/bf16 grid rounding) BEFORE quantization, commitment,
    noising and share generation, and `transform_dense()` does the same
    (downcast stages only — sparsifying a global model would zero it)
    for the minted block's `global_w`. Everything cryptographic —
    Pedersen verification, Shamir recovery, block hashes — therefore
    operates on the exact values receivers will decode.
  * **Wire plane — always bit-exact.** `encode_array()` only applies a
    downcast when the array already sits on that grid (checked, not
    assumed), packs top-k output by its zero pattern (a lossless sparse
    encoding of whatever support the transform produced), and zlib is
    lossless by construction. A full-precision payload from a peer that
    never ran the transform simply falls back stage-by-stage; nothing
    is ever rounded in transit. Non-float arrays — int64 Shamir share
    rows, uint8 VSS commitment tensors, packed signatures — are never
    coded at all: crypto-bearing payloads travel verbatim.

Codec names compose with ``+`` (canonical stage order
topk → bf16/f32 → zlib): ``raw64`` (legacy identity), ``f32``/``bf16``
(downcast), ``zlib`` (lossless deflate), ``topk`` (sparsification), e.g.
``f32+zlib`` or ``topk+f32+zlib``. Support is negotiated via a
capabilities set in the `RegisterPeer` hello; senders fall back to
``raw64`` for peers that never advertised (docs/WIRE_PLANE.md).

stdlib + numpy only — no jax, no asyncio: the config layer validates
codec names through `parse_codec` and the bench estimates frame sizes
without pulling the runtime in.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, FrozenSet, Optional, Tuple

import numpy as np

RAW = "raw64"
CHUNK_CAP = "chunk"  # capability token: peer reassembles continuation chunks

# canonical stage order: sparsify, then downcast, then compress
_STAGE_ORDER = ("topk", "bf16", "f32", "zlib")
_LOSSY = frozenset({"topk", "bf16", "f32"})

RAW_CAPS: FrozenSet[str] = frozenset({RAW})
FULL_CAPS: FrozenSet[str] = frozenset({RAW, CHUNK_CAP, *_STAGE_ORDER})

# deflate level 6: on quantized protocol payloads (update deltas and
# global weights are sums of 10^-precision-grid values) the win over
# level 1 is large (measured ~4x smaller frames on mnist_cnn blocks)
# for single-digit ms per MB — cheap against the RPC round-trips saved
ZLIB_LEVEL = 6

# compression-ratio histogram buckets (raw_bytes / wire_bytes): ratios
# live on a very different scale than the shared latency buckets
RATIO_BUCKETS: Tuple[float, ...] = (
    1.0, 1.25, 1.5, 2.0, 3.0, 5.0, 8.0, 16.0, 32.0, 64.0, 128.0, 512.0,
)

WIRE_BYTES_METRIC = "biscotti_wire_bytes_total"
WIRE_BYTES_HELP = "wire bytes by message type, direction and codec"
RATIO_METRIC = "biscotti_wire_compression_ratio"
RATIO_HELP = "raw-frame bytes over wire bytes, per codec"


class WireCodecError(ValueError):
    """Malformed codec name or corrupt coded payload."""


def parse_codec(name: str) -> Tuple[str, ...]:
    """Validate and canonicalize a codec name into its stage tuple.
    ``raw64`` (and ``""``) parse to the empty tuple. Raises
    WireCodecError on unknown stages, duplicates, or a downcast
    conflict (f32 and bf16 together)."""
    if not name or name == RAW:
        return ()
    stages = name.split("+")
    seen = set(stages)
    if len(seen) != len(stages):
        raise WireCodecError(f"duplicate stage in codec {name!r}")
    unknown = seen - set(_STAGE_ORDER) - {RAW}
    if unknown:
        raise WireCodecError(f"unknown codec stage(s) {sorted(unknown)} "
                             f"in {name!r}")
    if RAW in seen and len(seen) > 1:
        raise WireCodecError(f"{RAW} does not compose: {name!r}")
    if "f32" in seen and "bf16" in seen:
        raise WireCodecError(f"f32 and bf16 conflict in {name!r}")
    if RAW in seen:
        return ()
    return tuple(s for s in _STAGE_ORDER if s in seen)


def canonical(name: str) -> str:
    stages = parse_codec(name)
    return "+".join(stages) if stages else RAW


def capabilities(wire_codec: str) -> FrozenSet[str]:
    """The capability set a peer advertises in its `RegisterPeer` hello.
    A ``raw64``-configured peer advertises ONLY raw64 — strict legacy
    emulation, so mixed-cluster tests (and genuinely old peers, which
    send no capability set at all and default the same way) prove the
    graceful-fallback path for real."""
    if not parse_codec(wire_codec):
        return RAW_CAPS
    return FULL_CAPS


def negotiate(want: str, peer_caps) -> str:
    """The codec to use toward a peer advertising `peer_caps`: the full
    configured pipeline when every stage is supported, else ``raw64``
    (all-or-nothing — a partially-applied lossy pipeline would commit to
    values the wire then cannot carry compactly, for no meaningful win)."""
    try:
        stages = parse_codec(want)
    except WireCodecError:
        return RAW
    if not stages or not all(s in peer_caps for s in stages):
        return RAW
    return "+".join(stages)


# ------------------------------------------------------------- bf16 bits

def _bf16_bits(f32: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even truncation of f32 to bfloat16 bit patterns
    (uint16). Pure bit math — no ml_dtypes dependency."""
    u = np.ascontiguousarray(f32, dtype="<f4").view(np.uint32)
    return (((u + 0x7FFF + ((u >> 16) & 1)) >> 16) & 0xFFFF).astype("<u2")


def _bf16_to_f64(bits: np.ndarray) -> np.ndarray:
    return ((bits.astype(np.uint32) << 16).view("<f4")
            .astype(np.float64))


def _round_bf16(a64: np.ndarray) -> np.ndarray:
    return _bf16_to_f64(_bf16_bits(a64.astype("<f4")))


# --------------------------------------------------------- sparse packing

_TOPK_HDR = struct.Struct("<Q")  # entry count


def _pack_sparse(a: np.ndarray, downcast: Optional[str]) -> Optional[
        Tuple[bytes, Tuple[str, ...]]]:
    """Lossless sparse pack of a 1-D float64 array by its ZERO pattern:
    [u64 k][int32 indices][values]. Values ride downcast iff exactly
    representable. Returns None when the dense path is no bigger."""
    nz = np.flatnonzero(a)
    k = int(nz.size)
    vals = a[nz]
    tag = ["topk"]
    if downcast == "f32":
        v32 = vals.astype("<f4")
        if np.array_equal(v32.astype(np.float64), vals):
            vbuf, tag = v32.tobytes(), ["topk", "f32"]
        else:
            vbuf = vals.astype("<f8").tobytes()
    elif downcast == "bf16":
        bits = _bf16_bits(vals.astype("<f4"))
        if np.array_equal(_bf16_to_f64(bits), vals):
            vbuf, tag = bits.tobytes(), ["topk", "bf16"]
        else:
            vbuf = vals.astype("<f8").tobytes()
    else:
        vbuf = vals.astype("<f8").tobytes()
    packed = _TOPK_HDR.pack(k) + nz.astype("<i4").tobytes() + vbuf
    if len(packed) >= a.nbytes:
        return None
    return packed, tuple(tag)


def _unpack_sparse(raw: bytes, n: int, tag_stages: Tuple[str, ...],
                   shape: Tuple[int, ...]) -> np.ndarray:
    if len(raw) < _TOPK_HDR.size:
        raise WireCodecError("sparse payload truncated")
    (k,) = _TOPK_HDR.unpack(raw[: _TOPK_HDR.size])
    if k > n:
        raise WireCodecError("sparse entry count exceeds array size")
    vsize = 4 if "f32" in tag_stages else 2 if "bf16" in tag_stages else 8
    expect = _TOPK_HDR.size + k * (4 + vsize)
    if len(raw) != expect:
        raise WireCodecError("sparse payload length mismatch")
    idx = np.frombuffer(raw, "<i4", count=k, offset=_TOPK_HDR.size)
    if k and (int(idx.min()) < 0 or int(idx.max()) >= n
              or np.any(np.diff(idx) <= 0)):
        raise WireCodecError("sparse indices out of range or unsorted")
    voff = _TOPK_HDR.size + 4 * k
    if "f32" in tag_stages:
        vals = np.frombuffer(raw, "<f4", count=k,
                             offset=voff).astype(np.float64)
    elif "bf16" in tag_stages:
        vals = _bf16_to_f64(np.frombuffer(raw, "<u2", count=k, offset=voff))
    else:
        vals = np.frombuffer(raw, "<f8", count=k, offset=voff)
    out = np.zeros(n, dtype=np.float64)
    out[idx] = vals
    return out.reshape(shape)


# --------------------------------------------------------------- pipeline

class WireCodec:
    """One parsed codec pipeline. Stateless and shareable: error-feedback
    residuals are the CALLER's per-peer state (`transform` takes and
    returns them) so one registry instance serves every connection."""

    def __init__(self, name: str):
        self.stages = parse_codec(name)
        self.name = "+".join(self.stages) if self.stages else RAW
        self.lossy = any(s in _LOSSY for s in self.stages)
        self.sparsify = "topk" in self.stages
        self.downcast = ("f32" if "f32" in self.stages
                         else "bf16" if "bf16" in self.stages else None)
        self.compress = "zlib" in self.stages

    # ------------------------------------------------- protocol plane

    def transform(self, arr, residual: Optional[np.ndarray] = None,
                  topk_k: int = 0) -> Tuple[np.ndarray,
                                            Optional[np.ndarray]]:
        """Lossy projection of a delta onto this codec's representable
        set, applied BEFORE commitment/noising/sharing. Returns
        (projected float64 array, new error-feedback residual). The
        residual accumulates what top-k dropped (plus the downcast
        error of the kept entries) and is added back into the next
        round's delta, so sparsification error feeds forward instead of
        vanishing (the SGD-with-error-feedback construction the
        compressed-training literature relies on, PAPERS.md). Identity
        for lossless codecs. Idempotent: transform(transform(x)) ==
        transform(x) when the residual is not threaded back in."""
        a = np.ascontiguousarray(np.asarray(arr, dtype=np.float64))
        if not self.lossy:
            return a, residual
        v = a
        if self.sparsify and residual is not None and residual.shape == a.shape:
            v = a + residual
        out = v
        if self.sparsify and 0 < topk_k < v.size:
            keep = np.argpartition(np.abs(v), v.size - topk_k)[-topk_k:]
            out = np.zeros_like(v)
            out[keep] = v[keep]
        if self.downcast == "f32":
            out = out.astype(np.float32).astype(np.float64)
        elif self.downcast == "bf16":
            out = _round_bf16(out)
        new_residual = (v - out) if self.sparsify else residual
        return out, new_residual

    def transform_dense(self, arr) -> np.ndarray:
        """Downcast-only projection for payloads that must stay dense —
        the minted block's `global_w` (sparsifying the global model
        would zero most of it). Rounding the mint onto the downcast
        grid is what makes the wire downcast exact for block gossip,
        so the sealed hash verifies on every receiver."""
        a = np.ascontiguousarray(np.asarray(arr, dtype=np.float64))
        if self.downcast == "f32":
            return a.astype(np.float32).astype(np.float64)
        if self.downcast == "bf16":
            return _round_bf16(a)
        return a

    # ----------------------------------------------------- wire plane

    def encode_array(self, arr: np.ndarray) -> Optional[Tuple[bytes, str]]:
        """Bit-exact wire encoding of one array, or None to send raw.
        Float arrays only (crypto payloads are ints/bytes and must
        travel verbatim); each stage is applied only when exact and
        only while it actually shrinks the payload. Returns
        (payload bytes, applied-stage tag)."""
        if not self.stages or arr.dtype.kind != "f" or arr.size == 0:
            return None
        a = np.ascontiguousarray(arr)
        applied: Tuple[str, ...] = ()
        buf: Optional[bytes] = None
        if self.sparsify and a.ndim == 1 and a.dtype == np.float64:
            sp = _pack_sparse(a, self.downcast)
            if sp is not None:
                buf, applied = sp
        if buf is None:
            if self.downcast and a.dtype == np.float64:
                if self.downcast == "f32":
                    d32 = a.astype("<f4")
                    if np.array_equal(d32.astype(np.float64), a):
                        buf, applied = d32.tobytes(), ("f32",)
                else:
                    bits = _bf16_bits(a.astype("<f4"))
                    if np.array_equal(_bf16_to_f64(bits).reshape(a.shape), a):
                        buf, applied = bits.tobytes(), ("bf16",)
            if buf is None:
                buf = a.tobytes()
        if self.compress:
            z = zlib.compress(buf, ZLIB_LEVEL)
            if len(z) < len(buf):
                buf, applied = z, applied + ("zlib",)
        if not applied or len(buf) >= a.nbytes:
            return None
        return buf, "+".join(applied)


def decode_array(buf, dtype: str, shape: Tuple[int, ...],
                 tag: str) -> np.ndarray:
    """Decode one coded payload back to its declared (dtype, shape).
    `tag` is the per-array applied-stage tag from the frame header;
    hostile tags/payloads raise WireCodecError, never crash. The
    decompression-bomb cap: the inflate is bounded by what the declared
    shape can possibly need (the caller additionally bounds the summed
    declared sizes by MAX_FRAME), so a kilobyte frame cannot be made to
    materialize gigabytes."""
    stages = parse_codec(tag)
    if not stages:
        raise WireCodecError(f"empty codec tag {tag!r}")
    n = 1
    for s in shape:
        n *= int(s)
    out_dtype = np.dtype(dtype)
    data = bytes(buf)
    if "zlib" in stages:
        # worst legitimate inflated size: the sparse pack of a full-
        # support array (8 + n*(4+8)) or the dense buffer (n*itemsize)
        cap = max(n * out_dtype.itemsize, 12 * n + _TOPK_HDR.size)
        d = zlib.decompressobj()
        try:
            data = d.decompress(data, cap + 1)
        except zlib.error as e:
            raise WireCodecError(f"bad zlib stream: {e}") from e
        if len(data) > cap:
            raise WireCodecError("zlib payload inflates past declared size")
        if not d.eof or d.unconsumed_tail or d.unused_data:
            raise WireCodecError("trailing or truncated zlib stream")
    if "topk" in stages:
        if out_dtype != np.float64:
            raise WireCodecError("sparse payloads decode to float64 only")
        return _unpack_sparse(data, n, stages, tuple(int(s) for s in shape))
    if "f32" in stages or "bf16" in stages:
        enc = np.dtype("<f4") if "f32" in stages else np.dtype("<u2")
        if len(data) != n * enc.itemsize:
            raise WireCodecError("downcast payload length mismatch")
        flat = np.frombuffer(data, enc, count=n)
        out = (_bf16_to_f64(flat) if "bf16" in stages
               else flat.astype(np.float64))
        return out.reshape(shape).astype(out_dtype, copy=False)
    # zlib-only: data is the raw little-endian dense buffer
    if len(data) != n * out_dtype.itemsize:
        raise WireCodecError("decompressed payload length mismatch")
    return np.frombuffer(data, out_dtype.newbyteorder("<"),
                         count=n).reshape(shape)


_REGISTRY: Dict[str, WireCodec] = {}


def get(name: str) -> WireCodec:
    """Registry accessor: one shared WireCodec per canonical name.
    Raises WireCodecError on malformed names (config validation calls
    through here, so a typo'd --wire-codec fails at startup)."""
    key = canonical(name)
    wc = _REGISTRY.get(key)
    if wc is None:
        wc = _REGISTRY[key] = WireCodec(key)
    return wc


def observe_ratio(registry, codec: str, raw_bytes: int,
                  wire_bytes: int) -> None:
    """Feed the shared compression-ratio histogram (one definition for
    the RPC pool and the broadcast path in peer.py)."""
    if registry is None or codec == RAW or raw_bytes <= 0 or wire_bytes <= 0:
        return
    registry.histogram(RATIO_METRIC, RATIO_HELP,
                       buckets=RATIO_BUCKETS).observe(
        raw_bytes / wire_bytes, codec=codec)
