"""Twin of `tests/test_dkg.py::test_dkg_keyed_cluster_boots_and_mints`
on the port's peer: a cluster keyed by the dealerless genesis
(`tools.keygen.generate_dkg`) boots, mints with Pedersen commitments
under the transcript-derived key, keeps its chains equal and rejects
nothing.

Each package writes its own key directory from the same ceremony seed
and the same stream of node identity seeds (the OS's in the reference
test, a seeded stream here), and its cluster boots from that directory:
the two `genesis.json`, `commit_key.json` and `node_keys.json` must be
equal byte for byte. The twin runs 4 peers where the reference runs 3:
at 3 the genesis committee seats one node as verifier and miner, so two
workers race for round 0's one sample and the verifier pools whichever
arrives first (ROADMAP C8); at 4 with these identities each round's
workers are its sample, so nothing is decided by arrival. The
reference's scenario is plain mode, held to round 0's block, the
rejected ids and the stake rule (ROADMAP C10); the same keyed cluster
under secure aggregation, added, mints the reference's chain bit for
bit (`torch_twins.assert_same_chain_where_pooled_alike`).

Ports are 21600-21699, which no other test file uses."""

import os
import random
import secrets

import pytest

from torch_twins import (PACKAGES, assert_first_block_parity,
                         assert_same_chain_where_pooled_alike, cfg,
                         run_cluster, twin)

pytestmark = pytest.mark.dkg

# windows no honest peer misses under a loaded test run (the reference
# test's, test_dkg.py:255, are 4/20/4/4/6 s); an honest round mints as
# soon as its workers are accounted for, so they cost nothing
WINDOWS = dict(update_s=20.0, block_s=60.0, krum_s=20.0, share_s=20.0,
               rpc_s=20.0)
N = 4
IDENTITY_SEED = 1


def _key_dirs(tmp_path, monkeypatch) -> dict:
    dirs = {}
    for pkg in PACKAGES:
        draw = random.Random(IDENTITY_SEED)
        with monkeypatch.context() as m:
            m.setattr(secrets, "token_bytes",
                      lambda n: bytes(draw.getrandbits(8) for _ in range(n)))
            dirs[pkg.name] = out = str(tmp_path / pkg.name)
            genesis = pkg.keygen.generate_dkg(dims=50, nodes=N, out_dir=out,
                                              threshold=2, rng_seed=5)
        assert genesis["genesis"] == "dkg" \
            and genesis["rejected_dealers"] == []
    for name in ("genesis.json", "commit_key.json", "node_keys.json"):
        texts = [open(os.path.join(d, name)).read() for d in dirs.values()]
        assert texts[0] == texts[1], f"{name} differs across the packages"
    return dirs


def _keyed(pkg, port, draws, key_dirs, secure):
    results, agents = run_cluster(
        pkg, [cfg(pkg, i, N, port, WINDOWS, verification=True,
                  secure_agg=secure) for i in range(N)],
        draws=draws, key_dir=key_dirs[pkg.name])
    assert len({r["chain_dump"] for r in results}) == 1, \
        "DKG-keyed cluster forked"
    accepted = [u for b in agents[0].chain.blocks
                for u in b.data.deltas if u.accepted]
    assert accepted, "DKG-keyed cluster minted nothing"
    for u in accepted:
        assert len(u.commitment) == 32
    assert all(a.commit_key is not None for a in agents)
    assert sum(a.counters.get("submission_rejected", 0)
               for a in agents) == 0
    if secure:
        # these identities' committees seat as many workers as samples in
        # both rounds: no verifier refused a worker for arriving late (a
        # plain-mode round 1 follows other committees, ROADMAP C10)
        assert sum(a.counters.get("update_rejected", 0)
                   for a in agents) == 0
    return results, agents


@pytest.mark.parametrize("secure,port", [(False, 21600), (True, 21640)],
                         ids=["plain", "secure"])
def test_dkg_keyed_cluster_boots_and_mints(tmp_path, monkeypatch, secure,
                                           port):
    key_dirs = _key_dirs(tmp_path, monkeypatch)
    got = twin(lambda pkg, p, d: _keyed(pkg, p, d, key_dirs, secure), port)
    ref, mine = got["reference"], got["port"]
    # one commitment key: the transcript's, in both packages
    assert mine[1][0].commit_key.serialize() \
        == ref[1][0].commit_key.serialize()
    if secure:
        assert_same_chain_where_pooled_alike(ref, mine)
    else:
        assert_first_block_parity(ref[1][0], mine[1][0])
