"""The port's VRF (`crypto/vrf.py`), role election (`parallel/roles.py`) and
dealerless DKG (`crypto/dkg.py`) against the JAX package's, on the same
seeds: the cases of tests/test_vrf_roles.py:60-176 and
tests/test_dkg.py:34-158. Tolerance: exact — VRF outputs and proof bytes,
committees, noiser draws, role maps, DKG deals, joint grids, joint shares,
exclusions, transcripts and recovered secrets equal."""

import hashlib

import numpy as np
import pytest

from biscotti_tpu.crypto import dkg as rdkg
from biscotti_tpu.crypto import vrf as rvrf
from biscotti_tpu.parallel import roles as rR
from biscotti_tpu_torch.crypto import dkg
from biscotti_tpu_torch.crypto import vrf
from biscotti_tpu_torch.parallel import roles as R

N, K = 5, 3


# ----------------------------------------------------------------------- vrf


@pytest.mark.parametrize("seed,alpha", [
    (hashlib.sha256(b"peer-3-roles").digest(),
     hashlib.sha256(b"block-hash-7").digest()),
    (b"\x11" * 32, b"alpha"), (b"\x22" * 32, b"round-entropy"),
    (b"\x44" * 32, b"")], ids=["peer3", "x11", "x22", "x44-empty"])
def test_vrf_output_and_proof_bytes_equal_reference(seed, alpha):
    key, rkey = vrf.VRFKey(seed=seed), rvrf.VRFKey(seed=seed)
    assert key.public == rkey.public
    beta, pi = key.prove(alpha)
    assert (beta, pi) == rkey.prove(alpha)
    assert len(beta) == 64 and len(pi) == vrf.PROOF_LEN == rvrf.PROOF_LEN
    assert vrf.verify(key.public, alpha, pi) == beta == rvrf.verify(
        key.public, alpha, pi)
    assert key.prove(alpha) == (beta, pi)  # deterministic


def test_vrf_rejects_forgeries_like_reference():
    key, other = vrf.VRFKey(seed=b"\x22" * 32), vrf.VRFKey(seed=b"\x33" * 32)
    alpha = b"round-entropy"
    beta, pi = key.prove(alpha)
    bad = bytearray(pi)
    bad[40] ^= 1
    for pub, a, p in ((other.public, alpha, pi), (key.public, b"x", pi),
                      (key.public, alpha, bytes(bad)),
                      (key.public, alpha, pi[:-1]), (b"\x00" * 32, alpha, pi)):
        assert vrf.verify(pub, a, p) is None
        assert rvrf.verify(pub, a, p) is None
    with pytest.raises(ValueError):
        vrf.VRFKey(seed=b"short")


# --------------------------------------------------------------------- roles


def _stake(n, default=10):
    return {i: default for i in range(n)}


def test_lottery_and_draws_equal_reference():
    stake = {0: 1, 1: 3, 2: 0}
    assert R.lottery_tickets(stake, 3) == rR.lottery_tickets(stake, 3) \
        == [0, 1, 1, 1]
    for mod in (R, rR):
        with pytest.raises(ValueError):
            mod.lottery_tickets({0: 0}, 1)
    tickets = list(range(50))
    assert R.draw_winners(b"\xaa\xbb", tickets, 20) \
        == rR.draw_winners(b"\xaa\xbb", tickets, 20)
    t5 = R.lottery_tickets(_stake(5), 5)
    w = R.draw_winners(b"seed-entropy-string", t5, 4, exclude=2)
    assert w == rR.draw_winners(b"seed-entropy-string", t5, 4, exclude=2)
    assert 2 not in w and len(set(w)) == 4
    with pytest.raises(ValueError):
        R.draw_winners(b"seed", t5, 5, exclude=2)


@pytest.mark.parametrize("stake,n,nv,nm", [
    (_stake(10), 10, 3, 3), ({0: 10_000, 1: 1, 2: 1}, 3, 1, 0),
    ({i: i % 4 for i in range(40)}, 40, 5, 7), (_stake(100), 100, 3, 3)])
def test_committees_equal_reference(stake, n, nv, nm):
    for r in range(6):
        h = hashlib.sha256(f"blk{r}".encode()).digest()
        got = R.elect_committees(stake, h, nv, nm, n)
        assert got == rR.elect_committees(stake, h, nv, nm, n)
        assert len(set(got[0])) == nv and len(set(got[1])) == nm


def test_noiser_draws_equal_reference_and_verify():
    stake = _stake(8)
    h = hashlib.sha256(b"blk").digest()
    key, rkey = vrf.VRFKey(seed=b"\x44" * 32), rvrf.VRFKey(seed=b"\x44" * 32)
    draw = R.elect_noisers(key, stake, h, source_id=1, num_noisers=2,
                           total_nodes=8)
    rdraw = rR.elect_noisers(rkey, stake, h, source_id=1, num_noisers=2,
                             total_nodes=8)
    assert (draw.noisers, draw.output, draw.proof) \
        == (rdraw.noisers, rdraw.output, rdraw.proof)
    assert 1 not in draw.noisers and len(draw.noisers) == 2
    assert R.verify_noiser_draw(key.public, stake, h, 1, draw, 8)
    forged = R.NoiserDraw(noisers=[2, 3], output=draw.output, proof=draw.proof)
    if forged.noisers != draw.noisers:
        assert not R.verify_noiser_draw(key.public, stake, h, 1, forged, 8)
    other = vrf.VRFKey(seed=b"\x55" * 32)
    assert not R.verify_noiser_draw(other.public, stake, h, 1, draw, 8)


def test_role_map_equals_reference():
    args = (6, [0, 1], [1, 2], [3])
    rm, rrm = R.RoleMap.build(*args), rR.RoleMap.build(*args)
    assert rm.roles == rrm.roles
    assert rm.roles[1] == 6 and rm.roles[3] == 5 and rm.roles[4] == 1
    for node in range(7):
        for pred in ("is_verifier", "is_miner", "is_noiser", "is_vanilla"):
            assert getattr(rm, pred)(node) == getattr(rrm, pred)(node)
    assert rm.committee() == rrm.committee() == ([0, 1], [1, 2], [3], 3)


# ----------------------------------------------------------------------- dkg


@pytest.fixture(scope="module")
def ceremonies():
    return dkg.run_ceremony(N, K, rng_seed=7), rdkg.run_ceremony(N, K,
                                                                 rng_seed=7)


def _deal_equal(a, b):
    return (a.dealer_id == b.dealer_id and a.xs == b.xs
            and np.array_equal(a.comms, b.comms)
            and np.array_equal(a.rows, b.rows)
            and np.array_equal(a.blind_rows, b.blind_rows))


def test_ceremony_transcript_equals_reference(ceremonies):
    got, ref = ceremonies
    assert got.rejected == ref.rejected == []
    assert all(_deal_equal(a, b) for a, b in zip(got.deals, ref.deals,
                                                 strict=True))
    for a, b in zip(got.shares, ref.shares, strict=True):
        assert (a.party_id, a.x, a.dealers) == (b.party_id, b.x, b.dealers)
        assert np.array_equal(a.row, b.row)
        assert np.array_equal(a.blind_row, b.blind_row)
        assert np.array_equal(a.joint_comms, b.joint_comms)
        assert a.verify()
    assert got.transcript == ref.transcript and got.label == ref.label
    assert dkg.transcript_hash(list(reversed(got.deals))) == got.transcript
    a = dkg.recover_secret(got.shares[:K], K)
    assert np.array_equal(a, rdkg.recover_secret(ref.shares[:K], K))
    assert np.array_equal(a, dkg.recover_secret(got.shares[-K:], K))
    assert dkg.secret_digest(a) == rdkg.secret_digest(a)
    with pytest.raises(ValueError, match="below the ceremony threshold"):
        dkg.recover_secret(got.shares[:K - 1], K)


def test_contribute_equals_reference_and_refuses_degenerate():
    xs = dkg.share_points(4)
    assert xs == rdkg.share_points(4)
    a = dkg.contribute(0, xs, 2, b"seed-A" * 6)
    assert _deal_equal(a, rdkg.contribute(0, xs, 2, b"seed-A" * 6))
    assert a.digest() != dkg.contribute(0, xs, 2, b"seed-B" * 6).digest()
    assert dkg.verify_deal(a)
    assert a.comms.shape == (dkg.DKG_CHUNKS, 2, 64)
    for args, msg in (((0, [1, 2, 3], 1), "threshold must be >= 2"),
                      ((0, [1, 2], 3), "cannot hold"),
                      ((0, [0, 1, 2], 2), "distinct and nonzero")):
        with pytest.raises(ValueError, match=msg):
            dkg.contribute(*args, b"s" * 32)


def test_corrupted_deal_excluded_like_reference():
    got, ref = dkg.run_ceremony(N, K, 21), rdkg.run_ceremony(N, K, 21)
    for res in (got, ref):
        res.deals[2].rows = res.deals[2].rows.copy()
        res.deals[2].rows[1, 0] += 1
    assert not dkg.verify_deal(got.deals[2])
    rej, rrej = [], []
    shares = dkg.aggregate(got.deals, reject=rej)
    rshares = rdkg.aggregate(ref.deals, reject=rrej)
    assert rej == rrej == [2]
    assert all(s.dealers == [0, 1, 3, 4] for s in shares)
    for a, b in zip(shares, rshares, strict=True):
        assert np.array_equal(a.row, b.row)
        assert np.array_equal(a.joint_comms, b.joint_comms)
        assert a.verify()
    accepted = [d for d in got.deals if d.dealer_id != 2]
    assert dkg.commit_key_label(accepted) == rdkg.commit_key_label(
        [d for d in ref.deals if d.dealer_id != 2])
    bad = [dkg.DkgShare(party_id=s.party_id, x=s.x, row=s.row.copy(),
                        blind_row=s.blind_row, joint_comms=s.joint_comms,
                        dealers=s.dealers) for s in shares[:K]]
    bad[0].row[3] += 1
    assert not bad[0].verify()
    with pytest.raises(ValueError):
        dkg.recover_secret(bad, K)
    deal = dkg.contribute(0, dkg.share_points(3), 2, b"x" * 32)
    deal.rows = deal.rows + 1
    with pytest.raises(ValueError, match="no verifiable deals"):
        dkg.aggregate([deal])
