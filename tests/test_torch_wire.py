"""The port's wire plane (`biscotti_tpu_torch/runtime/{codecs,messages,
wire,protocol}.py`) against the JAX package's (`biscotti_tpu/runtime/`).

The same seeded inputs go through both packages; outputs must be equal
byte for byte and bit for bit (NaN payloads included), errors equal in
type and message:
  * codecs, for every name of `codecs._STAGE_ORDER` and each composition
    the parser accepts (and the ones it refuses): `transform` with and
    without an error-feedback residual on many equal |v| ties, NaN, ±inf,
    subnormals and values near FLT_MAX; `transform_dense`;
    `encode_array` / `decode_array`, each package decoding the other's;
  * frames: `encode` / `encode_parts`, chunked and not, `peek_header` and
    `decode` of each other's frames, and hostile frames;
  * wire packers: updates, blocks and chains, with the zero-copy float64
    decode;
  * protocol: the feature and message tables, `version_row` for every
    version, and `advertised`, `grant`, `degraded`, `serves`, `snapshot`
    over a grid of configs built from one dict."""

import itertools
import json
import struct
import types

import numpy as np
import pytest
import torch

from biscotti_tpu.config import BiscottiConfig as JConfig
from biscotti_tpu.ledger import block as rblock
from biscotti_tpu.runtime import codecs as rcodecs
from biscotti_tpu.runtime import messages as rmsgs
from biscotti_tpu.runtime import protocol as rproto
from biscotti_tpu.runtime import wire as rwire
from biscotti_tpu_torch.config import BiscottiConfig
from biscotti_tpu_torch.ledger import block as pblock
from biscotti_tpu_torch.runtime import codecs as pcodecs
from biscotti_tpu_torch.runtime import messages as pmsgs
from biscotti_tpu_torch.runtime import protocol as pproto
from biscotti_tpu_torch.runtime import wire as pwire

REF = types.SimpleNamespace(codecs=rcodecs, msgs=rmsgs, wire=rwire,
                            block=rblock, proto=rproto)
PORT = types.SimpleNamespace(codecs=pcodecs, msgs=pmsgs, wire=pwire,
                             block=pblock, proto=pproto)

STAGES = pcodecs._STAGE_ORDER
# every canonical codec name the parser accepts: raw64 and each set of
# stages without both downcasts
NAMES = ["raw64"] + ["+".join(c) for r in range(1, len(STAGES) + 1)
                     for c in itertools.combinations(STAGES, r)
                     if not {"f32", "bf16"} <= set(c)]
F32_MAX = float(np.finfo(np.float32).max)


def _try(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the observation is the point
        return ("raise", type(e).__name__, str(e))


def _bits(a):
    """An array's dtype, shape and raw bytes (NaN payloads included)."""
    if a is None:
        return None
    a = np.ascontiguousarray(a)
    return a.dtype.str, a.shape, a.tobytes()


def _inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    n = 257
    ties = rng.integers(-3, 4, n) * 0.25  # many equal |v|
    odd = rng.normal(size=n)
    odd[:12] = [np.nan, np.inf, -np.inf, 5e-324, -5e-324, 1e-40, -1e-45,
                F32_MAX, -F32_MAX, 3.4028235e38 * 1.0000001, 3.39e38, 0.0]
    odd[12] = -0.0
    return {"ties": ties, "nonfinite": odd,
            "f32_grid": rng.normal(size=n).astype(np.float32).astype(np.float64),
            "normal": rng.normal(0.0, 0.02, n)}


def test_codec_names_cover_every_composition():
    assert STAGES == rcodecs._STAGE_ORDER == ("topk", "bf16", "f32", "zlib")
    assert len(NAMES) == 1 + 11


@pytest.mark.parametrize("name", NAMES + [
    "", "zlib+f32", "f32+topk+zlib", "f32+bf16", "f32+f32", "raw64+zlib",
    "nope", "topk+gzip"])
def test_parse_negotiate_and_capabilities_equal_reference(name):
    def obs(c):
        return [_try(lambda: c.parse_codec(name)), _try(lambda: c.canonical(name)),
                _try(lambda: c.capabilities(name)),
                [c.negotiate(name, caps) for caps in (
                    c.RAW_CAPS, c.FULL_CAPS, frozenset({"raw64", "f32"}),
                    frozenset({"raw64", "zlib", "f32", "topk"}))],
                _try(lambda: c.get(name).name)]
    assert obs(pcodecs) == obs(rcodecs)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", ["ties", "nonfinite", "f32_grid", "normal"])
def test_transform_and_transform_dense_equal_reference(name, kind):
    x = _inputs()[kind]
    residual = np.random.default_rng(1).normal(0.0, 0.01, x.size)
    with np.errstate(all="ignore"):  # the casts past FLT_MAX warn alike
        for topk_k in (0, 7, x.size // 3, x.size):
            for res in (None, residual):
                r = rcodecs.get(name).transform(x, None if res is None
                                                else res.copy(), topk_k=topk_k)
                p = pcodecs.get(name).transform(x, None if res is None
                                                else res.copy(), topk_k=topk_k)
                assert [_bits(a) for a in p] == [_bits(a) for a in r]
        # the port's transform also takes the vector as a torch tensor
        t = pcodecs.get(name).transform(torch.from_numpy(x), topk_k=7)
        assert _bits(t[0]) == _bits(rcodecs.get(name).transform(x, topk_k=7)[0])
        assert _bits(pcodecs.get(name).transform_dense(x)) \
            == _bits(rcodecs.get(name).transform_dense(x))


@pytest.mark.parametrize("name", NAMES)
def test_encode_array_and_cross_decode_equal_reference(name):
    ins = _inputs(2)
    with np.errstate(all="ignore"):
        arrays = dict(ins, sparse=pcodecs.get("topk+f32").transform(
            ins["f32_grid"], topk_k=20)[0],
            bf16_grid=pcodecs._round_bf16(ins["normal"]),
            f32=ins["normal"].astype(np.float32), empty=np.zeros(0),
            two_d=ins["f32_grid"].reshape(1, -1),
            int64=np.arange(40, dtype=np.int64))
    for key, a in arrays.items():
        with np.errstate(all="ignore"):  # the casts past FLT_MAX warn alike
            r = rcodecs.get(name).encode_array(a)
            p = pcodecs.get(name).encode_array(a)
        assert p == r, key
        if r is None:
            continue
        buf, tag = r
        dr = rcodecs.decode_array(buf, a.dtype.name, a.shape, tag)
        dp = pcodecs.decode_array(buf, a.dtype.name, a.shape, tag)
        assert _bits(dp) == _bits(dr) == _bits(a), key


def test_decode_array_errors_equal_reference():
    import zlib

    good = zlib.compress(np.ones(8).tobytes())
    sparse = struct.pack("<Q", 3) + np.array([5, 5, 2], "<i4").tobytes() \
        + np.zeros(3, "<f8").tobytes()
    cases = [(good, "float64", (8,), ""), (good, "float64", (8,), "nope"),
             (good, "float64", (4,), "zlib"), (good[:-3], "float64", (8,), "zlib"),
             (good + b"x", "float64", (8,), "zlib"), (b"\0" * 8, "float64", (4,), "f32"),
             (sparse, "float64", (8,), "topk"), (sparse, "float32", (8,), "topk"),
             (sparse[:6], "float64", (8,), "topk"), (b"\0" * 12, "float64", (3,), "bf16")]
    for args in cases:
        r = _try(lambda: rcodecs.decode_array(*args))
        p = _try(lambda: pcodecs.decode_array(*args))
        assert (p[:3] if isinstance(p, tuple) else _bits(p)) == \
            (r[:3] if isinstance(r, tuple) else _bits(r)), args[1:]


# ----------------------------------------------------------------- frames


def _frame_inputs():
    rng = np.random.default_rng(3)
    return [("RegisterUpdate", {"iteration": 3, "source_id": 1, "x": [1, "a"]},
             {"d": rng.normal(size=300), "i": np.arange(10, dtype=np.int64)}),
            ("RegisterSecret", {"commitment": "00" * 32},
             {"share_rows": rng.integers(-9, 9, (7, 50)),
              "comms": rng.integers(0, 255, (5, 10, 64), dtype=np.uint8),
              "mask": np.array([True, False])}),
            ("Big", {"n": 1},
             {"d": rng.normal(size=40_000).astype(np.float32).astype(np.float64)}),
            ("Empty", None, None)]


@pytest.mark.parametrize("codec", [None] + NAMES[1:])
@pytest.mark.parametrize("chunk_bytes", [0, 65536, 100_000])
def test_frames_equal_reference_and_cross_decode(codec, chunk_bytes):
    for msg_type, meta, arrays in _frame_inputs():
        rs, ps = {}, {}
        r = rmsgs.encode(msg_type, meta, arrays, codec=codec,
                         chunk_bytes=chunk_bytes, stats=rs)
        p = pmsgs.encode(msg_type, meta, arrays, codec=codec,
                         chunk_bytes=chunk_bytes, stats=ps)
        assert p == r and ps == rs, msg_type
        parts = pmsgs.encode_parts(msg_type, meta, arrays, codec=codec,
                                   chunk_bytes=chunk_bytes)
        assert b"".join(bytes(x) for x in parts) == r
        if r[4:8] == pmsgs.CHUNK_MAGIC:  # a chunk run: reassemble it
            payload, off = b"", 0
            while off < len(r):
                (ln,) = struct.unpack(">I", r[off:off + 4])
                payload += r[off + 4 + pmsgs.CHUNK_OVERHEAD:off + 4 + ln]
                off += 4 + ln
        else:
            payload = r[4:]
        assert pmsgs.peek_header(payload) == rmsgs.peek_header(payload)
        for dec in (rmsgs.decode, pmsgs.decode):
            mt, dmeta, darr = dec(payload)
            assert mt == msg_type and dmeta == dict(meta or {}, _wire_codec=
                                                   dmeta["_wire_codec"])
            assert {k: _bits(v) for k, v in darr.items()} == \
                {k: _bits(v) for k, v in (arrays or {}).items()}


def test_chunked_frames_count_and_clamp_equal_reference():
    x = np.random.default_rng(4).normal(size=40_000)
    for chunk in (1, 65536, 70_000, pmsgs.MAX_FRAME):
        r = rmsgs.encode("T", {}, {"d": x}, chunk_bytes=chunk)
        assert pmsgs.encode("T", {}, {"d": x}, chunk_bytes=chunk) == r
    views = [memoryview(b"a" * 100_000), memoryview(b"b" * 50_000)]
    assert [bytes(v) for v in pmsgs._chunk_frames(views, 65536)] == \
        [bytes(v) for v in rmsgs._chunk_frames(views, 65536)]
    assert (pmsgs.MAX_FRAME, pmsgs.MIN_CHUNK, pmsgs.CHUNK_MAGIC,
            pmsgs.CHUNK_LAST, pmsgs.CHUNK_OVERHEAD) == \
        (rmsgs.MAX_FRAME, rmsgs.MIN_CHUNK, rmsgs.CHUNK_MAGIC,
         rmsgs.CHUNK_LAST, rmsgs.CHUNK_OVERHEAD)


def _hostile_payloads():
    import zlib

    bomb = zlib.compress(b"\0" * 65536, 9)

    def frame(arrays, extra=b"", **hdr):
        header = json.dumps({"type": "T", "meta": {}, "arrays": arrays, **hdr},
                            separators=(",", ":")).encode()
        return struct.pack(">I", len(header)) + header + extra

    good = pmsgs.encode("T", {}, {"d": np.ones(32)}, codec="topk+f32+zlib")[4:]
    out = [b"", b"\0\0", struct.pack(">I", 99) + b"{}", b"\0\0\0\2{}",
           struct.pack(">I", 4) + b"nope", frame([], type=5),
           frame([{"name": "d", "dtype": "float64", "shape": [rmsgs.MAX_FRAME],
                   "codec": "zlib", "nbytes": len(bomb)}], bomb, codec="zlib"),
           frame([{"name": "d", "dtype": "float64", "shape": [8],
                   "codec": "zlib", "nbytes": len(bomb)}], bomb),
           frame([{"name": "d", "dtype": "object", "shape": [1]}], b"\0" * 8),
           frame([{"name": "d", "dtype": "float64", "shape": [-1]}]),
           frame([{"name": "d", "dtype": "float64", "shape": [4]}], b"\0" * 8),
           frame([{"name": "d", "dtype": "float64", "shape": [4],
                   "codec": "zlib", "nbytes": 99}], b"\0" * 8)]
    for tag in ("nope", "f32+f32", "f32+bf16", "", "raw64+zlib"):
        out.append(frame([{"name": "d", "dtype": "float64", "shape": [4],
                           "codec": tag, "nbytes": 8}], b"\0" * 8))
    for off in range(40, min(len(good), 120), 7):
        bad = bytearray(good)
        bad[off] ^= 0xFF
        out.append(bytes(bad))
    return out


def test_hostile_frames_fail_alike():
    for payload in _hostile_payloads():
        r = _try(lambda: rmsgs.decode(payload))
        p = _try(lambda: pmsgs.decode(payload))
        if isinstance(r, tuple) and r and r[0] == "raise":
            assert p == ("raise", "CodecError", r[2]), payload[:40]
        else:
            assert p[0] == r[0] and p[1] == r[1]
            assert {k: _bits(v) for k, v in p[2].items()} == \
                {k: _bits(v) for k, v in r[2].items()}
        assert pmsgs.peek_header(payload) == rmsgs.peek_header(payload)


# ---------------------------------------------------------------- packers


def _update(L, seed, noise=True):
    rng = np.random.default_rng(seed)
    d = 50
    delta = rng.normal(size=d)
    kw = dict(noise=rng.normal(size=d), noised_delta=rng.normal(size=d)) \
        if noise else {}
    return L.block.Update(source_id=seed, iteration=2, delta=delta,
                          commitment=rng.bytes(32), accepted=True,
                          signatures=[rng.bytes(64)] * (seed % 3),
                          signers=list(range(seed % 3)), **kw)


def _block(L, seed):
    rng = np.random.default_rng(seed + 10)
    blk = L.block.Block(
        data=L.block.BlockData(iteration=2, global_w=rng.normal(size=50),
                               deltas=[_update(L, s, bool(s % 2))
                                       for s in range(3)]),
        prev_hash=rng.bytes(32), stake_map={2: 5, 0: 10, 1: 15})
    return blk.seal()


@pytest.mark.parametrize("codec", [None, "f32+zlib", "topk+bf16+zlib"])
def test_wire_packers_equal_reference(codec):
    for r_obj, p_obj, pack, unpack in (
            (_update(REF, 1), _update(PORT, 1), "pack_update", "unpack_update"),
            (_update(REF, 2, False), _update(PORT, 2, False), "pack_update",
             "unpack_update"),
            (_block(REF, 0), _block(PORT, 0), "pack_block", "unpack_block"),
            ([_block(REF, s) for s in range(2)],
             [_block(PORT, s) for s in range(2)], "pack_chain", "unpack_chain")):
        rm, ra = getattr(rwire, pack)(r_obj)
        pm, pa = getattr(pwire, pack)(p_obj)
        assert pm == rm and {k: _bits(v) for k, v in pa.items()} == \
            {k: _bits(v) for k, v in ra.items()}
        frame = pmsgs.encode("X", pm, pa, codec=codec)
        assert frame == rmsgs.encode("X", rm, ra, codec=codec)
        _, dm, da = pmsgs.decode(frame[4:])
        got = getattr(pwire, unpack)(dm, da)
        want = getattr(rwire, unpack)(*rmsgs.decode(frame[4:])[1:])
        if pack == "pack_chain":
            assert [b.hash for b in got] == [b.hash for b in want] == \
                [b.hash for b in p_obj]
            assert all(b.compute_hash() == b.hash for b in got)
        elif pack == "pack_block":
            assert got.hash == want.hash == got.compute_hash()
        else:
            assert got.canonical_bytes() == want.canonical_bytes() \
                == p_obj.canonical_bytes()


def test_unpack_update_is_zero_copy_on_float64():
    u = _update(PORT, 1)
    meta, arrays = pwire.pack_update(u)
    _, dm, da = pmsgs.decode(pmsgs.encode("U", meta, arrays)[4:])
    got = pwire.unpack_update(dm, da)
    assert np.shares_memory(got.delta, da["u.delta"])
    assert not got.delta.flags.writeable
    f32 = pwire.unpack_update(meta, {"u.delta": u.delta.astype(np.float32),
                                     "u.noise": u.noise,
                                     "u.noised": u.noised_delta})
    assert f32.delta.dtype == np.float64


# --------------------------------------------------------------- protocol


def test_protocol_tables_equal_reference():
    assert pproto.CURRENT_VERSION == rproto.CURRENT_VERSION
    assert {k: (f.id, f.version, f.summary) for k, f in pproto.FEATURES.items()} \
        == {k: (f.id, f.version, f.summary) for k, f in rproto.FEATURES.items()}
    assert {k: (m.name, m.version, m.feature, m.summary)
            for k, m in pproto.MESSAGES.items()} == \
        {k: (m.name, m.version, m.feature, m.summary)
         for k, m in rproto.MESSAGES.items()}
    for v in range(-1, pproto.CURRENT_VERSION + 2):
        assert _try(lambda: pproto.version_row(v)) == \
            _try(lambda: rproto.version_row(v))
    for caps in (None, "junk", 3, ["raw64", "f32"], ("trace",), {"busy"},
                 frozenset({"relay"})):
        assert pproto.normalize_hello(caps) == rproto.normalize_hello(caps)


CONFIG_GRID = [dict(wire_codec=c, trace=t, overlay=o, overlay_group=2 * o,
                    protocol_version=v)
               for c in ("raw64", "f32+zlib", "topk+bf16")
               for t in (False, True) for o in (False, True)
               for v in (-1, 0, 2, 5, 8)]


@pytest.mark.parametrize("kw", CONFIG_GRID,
                         ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_protocol_negotiation_equal_reference(kw):
    pcfg, rcfg = BiscottiConfig(**kw), JConfig(**kw)
    own_p, own_r = pproto.advertised(pcfg), rproto.advertised(rcfg)
    assert own_p == own_r
    assert pproto.effective_version(pcfg) == rproto.effective_version(rcfg)
    peers = [None, frozenset({"raw64"}), rproto.version_row(3),
             rproto.advertised(JConfig(wire_codec="f32", trace=True))]
    for rec in peers:
        assert pproto.grant(own_p, rec) == rproto.grant(own_r, rec)
        assert pproto.degraded(own_p, rec) == rproto.degraded(own_r, rec)
    assert [pproto.serves(own_p, m) for m in list(rproto.MESSAGES) + ["X"]] \
        == [rproto.serves(own_r, m) for m in list(rproto.MESSAGES) + ["X"]]
    by_peer = {3: rproto.degraded(own_r, peers[1]), 1: frozenset()}
    assert pproto.snapshot(pcfg, own_p, by_peer) == \
        rproto.snapshot(rcfg, own_r, by_peer)


@pytest.mark.parametrize("kw", [dict(wire_codec="nope"), dict(wire_topk=0.0),
                                dict(wire_topk=1.5), dict(wire_chunk_bytes=-1),
                                dict(protocol_version=9),
                                dict(protocol_version=-2), dict(overlay=True),
                                dict(overlay_group=-1)])
def test_config_wire_checks_refuse_like_reference(kw):
    with pytest.raises(ValueError) as r:
        JConfig(**kw)
    with pytest.raises(ValueError) as p:
        BiscottiConfig(**kw)
    assert str(p.value) == str(r.value)


def test_config_wire_defaults_equal_reference():
    p, r = BiscottiConfig(), JConfig()
    for k in ("overlay", "overlay_group", "wire_codec", "wire_chunk_bytes",
              "wire_topk", "trace", "protocol_version"):
        assert getattr(p, k) == getattr(r, k), k
