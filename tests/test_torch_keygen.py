"""The port's key generator (`biscotti_tpu_torch/tools/keygen.py`) against
the reference's: with each keygen module's `secrets.token_bytes` patched
to one seeded stream (restarted for each package; only the keygen
modules' own draws, so a native library's load-time self-test elsewhere
in the process takes nothing from it) and the DKG's `rng_seed` fixed,
every artifact (commit_key.json, node_keys.json, peers.txt,
genesis.json) is byte-equal, and the loaders read equal keys back."""

import os
import random
import types

import pytest

from biscotti_tpu.tools import keygen as jk
from biscotti_tpu_torch.tools import keygen as pk


def _seeded_bytes(seed):
    rng = random.Random(seed)
    return types.SimpleNamespace(
        token_bytes=lambda n=32: bytes(rng.getrandbits(8) for _ in range(n)))


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def _gen(mod, out, genesis, monkeypatch, **kw):
    monkeypatch.setattr(mod, "secrets", _seeded_bytes(5))
    if genesis == "dealer":
        mod.generate(dims=kw["dims"], nodes=kw["nodes"], out_dir=str(out),
                     base_port=17900)
        return None
    return mod.generate_dkg(dims=kw["dims"], nodes=kw["nodes"], out_dir=str(out),
                            base_port=17900, threshold=kw.get("threshold", 0),
                            rng_seed=kw["rng_seed"])


@pytest.mark.parametrize("genesis,kw", [
    ("dealer", dict(dims=12, nodes=3)),
    ("dealer", dict(dims=31, nodes=5)),
    ("dkg", dict(dims=12, nodes=4, rng_seed=3)),
    ("dkg", dict(dims=20, nodes=5, threshold=2, rng_seed=11)),
], ids=["dealer_small", "dealer_wide", "dkg_default_threshold", "dkg_t2"])
def test_keygen_artifacts_byte_equal_reference(genesis, kw, tmp_path, monkeypatch):
    got = _gen(pk, tmp_path / "port", genesis, monkeypatch, **kw)
    want = _gen(jk, tmp_path / "ref", genesis, monkeypatch, **kw)
    assert got == want
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "ref")
    assert set(files) >= {"commit_key.json", "node_keys.json", "peers.txt"}
    assert pk.load_node_keys(str(tmp_path / "port")) == \
        jk.load_node_keys(str(tmp_path / "ref"))
    assert pk.load_peers(str(tmp_path / "port")) == \
        jk.load_peers(str(tmp_path / "ref"))
    ck_p = pk.load_commit_key(str(tmp_path / "port"))
    ck_j = jk.load_commit_key(str(tmp_path / "ref"))
    assert ck_p.serialize() == ck_j.serialize()
    # the loader's cache hands the same parsed key back
    assert pk.load_commit_key(str(tmp_path / "port")) is ck_p


def test_ephemeral_dir_sizes_the_key_from_the_port_zoo(monkeypatch):
    monkeypatch.setattr(pk, "secrets", _seeded_bytes(1))
    d = pk.make_ephemeral_dir("creditcard", 3)
    monkeypatch.setattr(jk, "secrets", _seeded_bytes(1))
    j = jk.make_ephemeral_dir("creditcard", 3)
    try:
        assert _files(d) == _files(j)
    finally:
        for path in (d, j):
            for f in os.listdir(path):
                os.remove(os.path.join(path, f))
            os.rmdir(path)


def test_keygen_cli_matches_reference(tmp_path, monkeypatch, capsys):
    outs = []
    for mod, sub in ((pk, "p"), (jk, "j")):
        monkeypatch.setattr(mod, "secrets", _seeded_bytes(2))
        assert mod.main(["--dims", "9", "--nodes", "3", "--out",
                         str(tmp_path / sub), "--dkg-seed", "4"]) == 0
        outs.append((capsys.readouterr().out.replace(str(tmp_path / sub), "OUT"),
                     _files(tmp_path / sub)))
    assert outs[0] == outs[1]
