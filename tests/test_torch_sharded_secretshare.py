"""The port's chunk-sharded share pipeline
(`biscotti_tpu_torch/ops/secretshare.py::make_sharded_share_fns`) on gloo
meshes of 2 and 4 CPU ranks, against the reference's
`make_sharded_share_fns` on the suite's 8-device virtual CPU mesh and the
port's host path (`make_shares`, `aggregate_shares`, `recover_coeffs`),
as the reference's test_sharded_chunk_axis_matches_unsharded holds its
own: shares, their sum over 3 peers and the recovered coefficients bit for
bit, at d = 10·ranks·2, 7,850 and 164,266 (mnist_cnn), 20 shares.

The chunk axis is padded to a multiple of 8 (`to_chunks(...,
chunk_multiple=8)`) so that one coefficient array divides over the
reference's 8 devices and the port's 2 or 4 ranks. JAX is imported inside
the reference-side helper only: the spawned ranks import this module and
stay JAX-free."""

import numpy as np
import pytest
import torch

from biscotti_tpu_torch.ops import secretshare as ss
from biscotti_tpu_torch.parallel import mesh as pm

TOTAL = 20
PEERS = 3
WORLDS = (2, 4)
TIMEOUT_S = 120.0


def _widths(world):
    return (10 * world * 2, 7_850, 164_266)


def _inputs(d):
    """Three peers' quantized updates [3, d] and their coefficients
    [3, C, k], C a multiple of 8."""
    rng = np.random.default_rng(d)
    q = rng.integers(-10 ** 4, 10 ** 4, size=(PEERS, d), dtype=np.int64)
    return q, np.stack([ss.to_chunks(qi, chunk_multiple=8) for qi in q])


def _reference(d):
    import jax.numpy as jnp

    import jax
    from biscotti_tpu.ops import secretshare as jss

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("chunks",))
    make_sh, agg_sh, recover_sh = jss.make_sharded_share_fns(
        mesh, total_shares=TOTAL)
    _, coeffs = _inputs(d)
    shares = np.stack([np.asarray(make_sh(jnp.asarray(c))) for c in coeffs])
    agg = np.asarray(agg_sh(jnp.asarray(shares)))
    rec = np.asarray(recover_sh(jnp.asarray(agg), jss.share_xs(TOTAL)))
    return shares, agg, rec


def _rank(mesh, widths):
    """This rank's results of the three functions at every width."""
    make_sh, agg_sh, recover_sh = ss.make_sharded_share_fns(
        mesh, total_shares=TOTAL)
    out = {}
    for d in widths:
        _, coeffs = _inputs(d)
        shares = torch.stack([make_sh(c) for c in coeffs])
        agg = agg_sh(shares)
        rec = recover_sh(agg, ss.share_xs(TOTAL))
        out[d] = tuple(t.numpy() for t in (shares, agg, rec))
    return out


@pytest.fixture(scope="module")
def worlds():
    return {k: pm.spawn(_rank, k, "cpu", args=(_widths(k),), axis="chunks",
                        timeout_s=TIMEOUT_S) for k in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("width", [0, 1, 2],
                         ids=["d=20*ranks", "d=7850", "d=164266"])
def test_sharded_share_fns_match_reference_and_host_path(worlds, world, width):
    d = _widths(world)[width]
    want = _reference(d)
    q, _ = _inputs(d)
    c = ss.num_chunks(d)
    host_shares = np.stack([ss.make_shares(qi, total_shares=TOTAL) for qi in q])
    host_agg = ss.aggregate_shares(host_shares)
    host_rec = ss.recover_coeffs(host_agg, ss.share_xs(TOTAL))
    for rank in worlds[world]:
        shares, agg, rec = rank[d]
        for got, ref in zip((shares, agg, rec), want):
            assert got.dtype == np.int64 and np.array_equal(got, ref)
        assert np.array_equal(shares[..., :c], host_shares)
        assert not shares[..., c:].any()  # the padding chunks share as 0
        assert np.array_equal(agg[:, :c], host_agg)
        assert np.array_equal(rec[:c], host_rec)
        assert np.array_equal(ss.from_chunks(rec, d), q.sum(axis=0))


def test_sharded_share_fns_need_the_chunk_axis(tmp_path):
    with pm.open_mesh("peers", "cpu", rank=0, world_size=1,
                      init_method=f"file://{tmp_path}/rendezvous") as mesh:
        with pytest.raises(ValueError, match="no axis 'chunks'"):
            ss.make_sharded_share_fns(mesh)
        make_sh, agg_sh, recover_sh = ss.make_sharded_share_fns(mesh, axis="peers")
        q, coeffs = _inputs(30)
        shares = make_sh(coeffs[0])
        assert np.array_equal(shares.numpy()[:, :3],
                              ss.make_shares(q[0], total_shares=TOTAL))
