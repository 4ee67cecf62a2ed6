"""The port's copy of `biscotti_tpu/runtime/messages.py`: the same frames,
byte for byte, and the same `CodecError`s.

Wire codec: length-prefixed frames carrying a JSON header + raw or
codec-compressed ndarray payloads.

Replaces the reference's encoding/gob (ref: DistSys/main.go:609-610 gob type
registration; kyber points marshalled to []byte for the wire,
kyber.go:88-168). Dense float/int arrays — the bulk of every message — ride
as raw little-endian bytes after the header, so a d=7,850 update costs
~63 KB, not a JSON blow-up; everything else (ids, iterations, commitments as
hex) is JSON. No pickle anywhere: peers are untrusted
(Byzantine model), and the decoder only materialises declared dtypes/shapes.

Frame:    [u32 BE frame_len][payload]
Payload:  [u32 BE header_len][header JSON][array bytes …]
Header:   {"type": str, "meta": {...}, "arrays": [{"name","dtype","shape",
           ("codec","nbytes")?}], ("codec": str)?}

Wire data plane (runtime/codecs.py, docs/WIRE_PLANE.md): when a codec is
negotiated, eligible float arrays travel as coded payloads — the
descriptor then carries the applied per-array stage tag plus the coded
byte count, and the header's frame-level "codec" names the negotiated
pipeline (the telemetry label). Arrays without a tag are the legacy raw
encoding byte-for-byte, so an old peer's frames decode unchanged and a
raw64-negotiated frame is bit-identical to the seed format.

Distributed tracing (telemetry/tracectx.py): toward peers that
advertised the `trace` capability, meta carries one compact entry
`"_tr": [trace_id, span_id, round]` — the sender's current span, which
the receiver's dispatch span adopts as parent. It is ordinary meta:
this codec neither adds nor strips it, so untraced frames are
byte-identical to the pre-tracing format, and a chunked payload carries
it in the header that rides the head of the continuation run.

Chunked streaming: a payload larger than `chunk_bytes` is emitted as a
run of continuation frames, each payload-prefixed with CHUNK_MAGIC + a
flags byte (bit 0 = last). rpc.FrameStream reassembles the run back into
one payload before decode, enforcing MAX_FRAME on the REASSEMBLED size —
so honest multi-MB payloads never require a single multi-MB socket read
buffer, while the frame cap still bounds total memory. CHUNK_MAGIC is an
impossible header length (> MAX_FRAME), so a pre-chunking decoder rejects
a stray chunk frame as malformed instead of misparsing it; senders only
chunk toward peers that advertised the `chunk` capability.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

from biscotti_tpu_torch.runtime import codecs as wcodecs

MAX_FRAME = 256 * 1024 * 1024  # hard cap against hostile length prefixes

# continuation-chunk framing (see module docstring): payload =
# MAGIC(4) + flags(1) + chunk bytes; MIN_CHUNK floors hostile/absurd
# chunk sizes so a reply cannot be shattered into per-byte frames
CHUNK_MAGIC = b"\xff\xff\xff\xff"
CHUNK_LAST = 0x01
CHUNK_OVERHEAD = 4 + 1  # magic + flags, per chunk payload
MIN_CHUNK = 64 * 1024

_ALLOWED_DTYPES = {"float32", "float64", "int32", "int64", "uint8", "bool"}


class CodecError(ValueError):
    pass


def _chunk_frames(payload_parts: list, chunk_bytes: int) -> list:
    """Split one frame payload (a list of buffers) into a run of
    continuation-chunk frames without flattening: chunk bodies are
    sub-views of the original buffers."""
    # clamp so every chunk FRAME (body + magic + flags) stays inside the
    # reader's frame cap — a near-MAX_FRAME chunk size must not produce
    # frames the receiving FrameStream rejects outright
    chunk_bytes = min(max(MIN_CHUNK, int(chunk_bytes)),
                      MAX_FRAME - CHUNK_OVERHEAD)
    views = [memoryview(p) if not isinstance(p, memoryview) else p
             for p in payload_parts]
    chunks: list = []  # list of (body_parts, body_len)
    cur: list = []
    cur_len = 0
    for v in views:
        off = 0
        while off < len(v):
            take = min(len(v) - off, chunk_bytes - cur_len)
            cur.append(v[off: off + take])
            cur_len += take
            off += take
            if cur_len == chunk_bytes:
                chunks.append((cur, cur_len))
                cur, cur_len = [], 0
    chunks.append((cur, cur_len))  # final (possibly empty) chunk
    out: list = []
    for i, (body, blen) in enumerate(chunks):
        last = i == len(chunks) - 1
        out.append(struct.pack(">I", CHUNK_OVERHEAD + blen))
        out.append(CHUNK_MAGIC)
        out.append(bytes([CHUNK_LAST if last else 0]))
        out.extend(body)
    return out


def encode_parts(msg_type: str, meta: Dict[str, Any] | None = None,
                 arrays: Dict[str, np.ndarray] | None = None,
                 codec: Optional[str] = None, chunk_bytes: int = 0,
                 stats: Optional[dict] = None) -> list:
    """Frame as a list of buffers (prefix + header + one memoryview per
    array) for part-wise transport writes — multi-MB payloads (VSS
    commitment tensors, model weights) never get flattened into one big
    bytearray on the event loop. The views alias the caller's arrays:
    callers must not mutate an array between handing it to the codec and
    the write draining (protocol code treats packed arrays as immutable —
    fresh per round).

    `codec` (a negotiated codecs.py pipeline name) compresses eligible
    float arrays; `chunk_bytes` > 0 splits an oversized payload into
    continuation chunks (only toward peers that advertised the `chunk`
    capability). `stats`, when given, is filled with
    {"raw_bytes", "wire_bytes"} for the byte-accounting plane."""
    meta = meta or {}
    arrays = arrays or {}
    wc = (wcodecs.get(codec)
          if codec and codec != wcodecs.RAW else None)
    descs = []
    blobs = []
    nbytes = 0
    raw_bytes = 0
    coded = False
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype.name not in _ALLOWED_DTYPES:
            raise CodecError(f"dtype {arr.dtype} not allowed on the wire")
        raw_bytes += arr.nbytes
        desc = {"name": name, "dtype": arr.dtype.name,
                "shape": list(arr.shape)}
        enc = wc.encode_array(arr) if wc is not None else None
        if enc is not None:
            buf, tag = enc
            desc["codec"] = tag
            desc["nbytes"] = len(buf)
            mv = memoryview(buf)
            coded = True
        else:
            mv = memoryview(arr).cast("B")
        descs.append(desc)
        blobs.append(mv)
        nbytes += len(mv)
    hobj: Dict[str, Any] = {"type": msg_type, "meta": meta, "arrays": descs}
    if coded:
        hobj["codec"] = wc.name
    header = json.dumps(hobj, separators=(",", ":")).encode()
    total = 4 + len(header) + nbytes
    # encoder and reader share ONE bound: payload <= MAX_FRAME — a
    # maximal frame produced here is accepted by FrameStream, and
    # vice versa (the seed's encoder was 4 bytes stricter than its
    # reader, an off-by-frame-prefix asymmetry)
    if total > MAX_FRAME:
        raise CodecError("frame too large")
    payload = [struct.pack(">I", len(header)), header] + blobs
    if chunk_bytes and total > max(MIN_CHUNK, int(chunk_bytes)):
        parts = _chunk_frames(payload, chunk_bytes)
    else:
        parts = [struct.pack(">I", total)] + payload
    if stats is not None:
        stats["raw_bytes"] = 8 + len(header) + raw_bytes
        stats["wire_bytes"] = sum(len(p) for p in parts)
        # the EFFECTIVE frame codec — raw64 when no array actually took
        # a coded path (e.g. a crypto-only RegisterSecret toward a
        # codec-negotiated peer): byte accounting must label what went
        # on the wire, matching what the receiver's header-driven count
        # will say, not what was negotiated
        stats["codec"] = hobj.get("codec", wcodecs.RAW)
    return parts


def encode(msg_type: str, meta: Dict[str, Any] | None = None,
           arrays: Dict[str, np.ndarray] | None = None,
           codec: Optional[str] = None, chunk_bytes: int = 0,
           stats: Optional[dict] = None) -> bytes:
    """One contiguous frame (or run of chunk frames) — for pre-encoded
    broadcast frames written to many peers (encode once, write N
    times); per-call paths use encode_parts."""
    return b"".join(encode_parts(msg_type, meta, arrays, codec=codec,
                                 chunk_bytes=chunk_bytes, stats=stats))


def peek_header(payload) -> Optional[Tuple[str, Dict[str, Any]]]:
    """Parse ONLY the frame's JSON header — no array materialization, no
    zlib inflate. The admission boundary (rpc.RPCServer, docs/ADMISSION.md)
    budgets every frame on (msg_type, meta) BEFORE paying its decode
    cost; without this, a flooder's shed frames would still pin the
    event loop with full-frame decompression. Returns None on any
    malformation (callers drop the connection, exactly as decode's
    CodecError path would). `meta["_wire_codec"]` is set from the header
    the same authoritative way decode sets it."""
    try:
        if len(payload) < 4:
            return None
        (hlen,) = struct.unpack(">I", payload[:4])
        if hlen > len(payload) - 4:
            return None
        header = json.loads(bytes(payload[4: 4 + hlen]).decode())
        msg_type = header["type"]
        meta = header.get("meta", {})
        if not isinstance(msg_type, str) or not isinstance(meta, dict):
            return None
        meta["_wire_codec"] = header.get("codec", wcodecs.RAW)
        return msg_type, meta
    except Exception:
        return None


def decode(payload: bytes) -> Tuple[str, Dict[str, Any], Dict[str, np.ndarray]]:
    """Decode one frame payload (the bytes after the frame-length prefix,
    chunk runs already reassembled by rpc.FrameStream). Raises CodecError
    on any malformation — a Byzantine peer must not be able to crash an
    honest one with a bad frame, inflate a decompression bomb (the summed
    DECLARED decoded sizes are capped at MAX_FRAME before any inflate
    runs, and each coded array's inflate is bounded by its declared
    shape), or smuggle a spoofed codec label (`meta["_wire_codec"]` is
    overwritten from the header, never trusted from meta)."""
    try:
        if len(payload) < 4:
            raise CodecError("short frame")
        (hlen,) = struct.unpack(">I", payload[:4])
        if hlen > len(payload) - 4:
            raise CodecError("header length exceeds frame")
        header = json.loads(payload[4 : 4 + hlen].decode())
        msg_type = header["type"]
        meta = header.get("meta", {})
        if not isinstance(msg_type, str) or not isinstance(meta, dict):
            raise CodecError("malformed header")
        arrays: Dict[str, np.ndarray] = {}
        # toreadonly(): FrameStream may hand us a bytearray-backed frame, and
        # frombuffer over a writable buffer yields writable views — force the
        # read-only invariant regardless of the payload's buffer type
        mv = memoryview(payload).toreadonly()
        off = 4 + hlen
        declared = 0
        for desc in header.get("arrays", []):
            dtype = desc["dtype"]
            if dtype not in _ALLOWED_DTYPES:
                raise CodecError(f"dtype {dtype} not allowed")
            shape = tuple(int(s) for s in desc["shape"])
            if any(s < 0 for s in shape):
                raise CodecError("negative dim")
            count = int(np.prod(shape)) if shape else 1
            nbytes = count * np.dtype(dtype).itemsize
            declared += nbytes
            if declared > MAX_FRAME:
                raise CodecError("declared decoded size exceeds frame cap")
            tag = desc.get("codec")
            if tag:
                enc_n = int(desc["nbytes"])
                if enc_n < 0 or off + enc_n > len(payload):
                    raise CodecError("coded bytes exceed frame")
                try:
                    arrays[desc["name"]] = wcodecs.decode_array(
                        mv[off: off + enc_n], dtype, shape, tag)
                except wcodecs.WireCodecError as e:
                    raise CodecError(f"bad coded array: {e}") from e
                off += enc_n
                continue
            if off + nbytes > len(payload):
                raise CodecError("array bytes exceed frame")
            # zero-copy READ-ONLY view into the frame (frombuffer over
            # bytes is non-writable): receivers that need a mutable or
            # differently-typed array copy at their own call site; an
            # accidental in-place write raises instead of corrupting
            arrays[desc["name"]] = np.frombuffer(
                mv[off: off + nbytes], dtype=dtype).reshape(shape)
            off += nbytes
        # frame-level codec label for the byte-accounting plane —
        # authoritative from the header, squashing any spoofed meta key
        meta["_wire_codec"] = header.get("codec", wcodecs.RAW)
        return msg_type, meta, arrays
    except CodecError:
        raise
    except Exception as e:  # json errors, missing keys, bad shapes …
        raise CodecError(f"bad frame: {e}") from e


# NOTE: frame READING lives in rpc.FrameStream (BufferedProtocol — the
# transport fills each frame's preallocated buffer directly, and
# reassembles continuation-chunk runs); this module owns only the byte
# format (length prefix + encode/decode + chunk splitting).
