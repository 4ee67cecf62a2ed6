"""The port's RPC layer (`biscotti_tpu_torch/runtime/rpc.py`) against the
JAX package's (`biscotti_tpu/runtime/rpc.py`) on loopback TCP.

A port client (`Pool`, `call`) talks to a reference `RPCServer` and a
reference client to a port server, plain and chunked, raw64 and under a
negotiated reply codec, with the reference's typed errors (stale, busy,
plain); every reply must arrive bit for bit. The frame-level hostile case
of tests/test_hostile_rpc.py (the shared MAX_FRAME bound of encoder and
reader) holds for both `FrameStream`s alike, and truncated, oversized and
bad-header frames sent at a bare server of either package end the same
way. Every server binds port 0 and reads its port back from its socket,
so test workers never collide. (The `PeerAgent` cases of
tests/test_hostile_rpc.py wait for the port's peer.)"""

import asyncio
import struct
import types

import numpy as np
import pytest

from biscotti_tpu.runtime import codecs as rcodecs
from biscotti_tpu.runtime import messages as rmsgs
from biscotti_tpu.runtime import rpc as rrpc
from biscotti_tpu_torch.runtime import codecs as pcodecs
from biscotti_tpu_torch.runtime import messages as pmsgs
from biscotti_tpu_torch.runtime import rpc as prpc

REF = types.SimpleNamespace(rpc=rrpc, msgs=rmsgs, codecs=rcodecs)
PORT = types.SimpleNamespace(rpc=prpc, msgs=pmsgs, codecs=pcodecs)
HOST = "127.0.0.1"
BIG = np.random.default_rng(9).normal(size=60_000).astype(
    np.float32).astype(np.float64)  # ~480 KB, on the f32 grid


def _handler(L):
    """An echo handler that raises package L's typed errors on request."""
    async def handle(msg_type, meta, arrays):
        if msg_type == "Stale":
            raise L.rpc.StaleError("iteration 3 is past")
        if msg_type == "Busy":
            raise L.rpc.BusyError("queue full")
        if msg_type == "Fail":
            raise L.rpc.RPCError("no such round")
        if msg_type == "Bug":
            raise KeyError("oops")
        return ({"echo_type": msg_type, "n": len(arrays),
                 "codec_in": meta.get("_wire_codec")},
                {k: np.array(v) for k, v in arrays.items()})
    return handle


async def _serve(L, full_caps=True):
    srv = L.rpc.RPCServer(HOST, 0, _handler(L))
    if full_caps:
        srv.caps = L.codecs.FULL_CAPS
    await srv.start()
    return srv, srv._server.sockets[0].getsockname()[1]


def _calls(client, port):
    """(kind, args) of every call the round trip makes."""
    small = {"d": np.arange(12, dtype=np.float64),
             "i": np.arange(5, dtype=np.int64),
             "u": np.arange(64, dtype=np.uint8).reshape(2, 32)}
    return [("Echo", {"k": 1}, small, {}),
            ("Echo", {"k": 2}, {}, {}),
            ("Big", {"achunk": 65536}, {"d": BIG}, dict(chunk_bytes=65536)),
            ("Big", {"acodec": "f32+zlib"}, {"d": BIG}, dict(codec="f32+zlib")),
            ("Big", {"acodec": "f32+zlib", "achunk": 65536}, {"d": BIG},
             dict(codec="f32+zlib", chunk_bytes=65536))]


async def _round_trip(client, server):
    srv, port = await _serve(server)
    pool = client.rpc.Pool()
    out = []
    try:
        for msg_type, meta, arrays, kw in _calls(client, port):
            rmeta, rarrays = await pool.call(HOST, port, msg_type, meta,
                                             arrays, timeout=20.0, **kw)
            out.append((rmeta, {k: (v.dtype.str, v.shape, v.tobytes())
                                for k, v in rarrays.items()}))
        for msg_type in ("Stale", "Busy", "Fail", "Bug"):
            try:
                await pool.call(HOST, port, msg_type, {}, {}, timeout=10.0)
                out.append(("no error", msg_type))
            except client.rpc.RPCError as e:
                out.append((type(e).__name__, e.reason, e.stale,
                            getattr(e, "busy", False)))
        rmeta, rarrays = await client.rpc.call(HOST, port, "Echo", {"one": 1},
                                               {"d": np.ones(3)}, timeout=10.0)
        out.append((rmeta, {k: v.tobytes() for k, v in rarrays.items()}))
    finally:
        pool.close()
        await srv.stop()
    return out


@pytest.mark.parametrize("client,server", [("port", "ref"), ("ref", "port"),
                                           ("port", "port")])
def test_loopback_round_trip_interoperates(client, server):
    pick = {"port": PORT, "ref": REF}
    got = asyncio.run(_round_trip(pick[client], pick[server]))
    want = asyncio.run(_round_trip(REF, REF))
    assert got == want
    big = BIG.tobytes()
    assert [o[1]["d"][2] == big for o in got[2:5]] == [True] * 3
    assert got[3][0]["codec_in"] == "f32+zlib"
    assert got[5] == ("StaleError", "iteration 3 is past", True, False)
    assert got[6][:2] == ("BusyError", "queue full")
    assert got[7][:2] == ("RPCError", "no such round")
    assert got[8][1].startswith("internal: KeyError")


@pytest.mark.parametrize("L", [REF, PORT], ids=["ref", "port"])
def test_max_frame_bound_symmetric_encoder_vs_reader(monkeypatch, L):
    """tests/test_hostile_rpc.py:148 on each package: a maximal frame
    from the encoder is accepted by the reader, one byte more is refused
    by both."""
    monkeypatch.setattr(L.msgs, "MAX_FRAME", 8192)
    overhead = len(L.msgs.encode("T", {"pad": ""})) - 4
    frame = L.msgs.encode("T", {"pad": "x" * (8192 - overhead)})
    assert len(frame) - 4 == 8192
    fs = L.rpc.FrameStream()
    fs._acc += frame
    fs._drain_acc()
    assert fs._exc is None
    payload = fs._frames.get_nowait()
    assert len(payload) == 8192 and L.msgs.decode(payload)[0] == "T"
    with pytest.raises(L.msgs.CodecError):
        L.msgs.encode("T", {"pad": "x" * 8192})
    fs2 = L.rpc.FrameStream()
    fs2._acc += struct.pack(">I", 8193) + b"\0" * 16
    fs2._drain_acc()
    assert fs2._exc is not None


def _frame(header: bytes) -> bytes:
    payload = struct.pack(">I", len(header)) + header
    return struct.pack(">I", len(payload)) + payload


def _hostile_streams():
    ok = pmsgs.encode("Echo", {"rid": 7}, {"d": np.ones(4)})
    header = b'{"type": 5}'
    return {
        "truncated": ok[:-9],
        "oversized": struct.pack(">I", pmsgs.MAX_FRAME + 1) + b"\0" * 64,
        "bad_header_json": _frame(b"{not-json"),
        "bad_header_type": _frame(header),
        "header_past_frame": struct.pack(">I", 8) + struct.pack(">I", 99)
        + b"{}{}",
        "garbled_then_honest": b"\0\0\0\4\0\0\0\0" + ok,
        "honest": ok,
    }


async def _send_raw(L, data: bytes):
    """What a bare server of package L does with `data` on one connection:
    the reply frame it sends (decoded), or how the connection ended."""
    srv, port = await _serve(L, full_caps=False)
    try:
        reader, writer = await asyncio.open_connection(HOST, port)
        writer.write(data)
        await writer.drain()
        try:
            head = await asyncio.wait_for(reader.readexactly(4), 2.0)
            (n,) = struct.unpack(">I", head)
            body = await asyncio.wait_for(reader.readexactly(n), 2.0)
            mt, meta, arrays = pmsgs.decode(body)
            result = ("reply", mt, meta, {k: v.tobytes() for k, v in arrays.items()})
        except asyncio.IncompleteReadError:
            result = ("closed",)
        except asyncio.TimeoutError:
            result = ("open, no reply",)
        writer.close()
        return result
    finally:
        await srv.stop()


@pytest.mark.parametrize("case", list(_hostile_streams()))
def test_bare_server_ends_hostile_frames_like_reference(case):
    data = _hostile_streams()[case]
    got = asyncio.run(_send_raw(PORT, data))
    want = asyncio.run(_send_raw(REF, data))
    assert got == want
    assert got[0] == ("reply" if case == "honest" else
                      "open, no reply" if case == "truncated" else "closed")


def test_geo_latency_equals_reference():
    for node in range(6):
        p = prpc.geo_latency(node, 8000, 3, 6, 0.05)
        r = rrpc.geo_latency(node, 8000, 3, 6, 0.05)
        assert [p(HOST, 8000 + j) for j in range(-1, 8)] == \
            [r(HOST, 8000 + j) for j in range(-1, 8)]
