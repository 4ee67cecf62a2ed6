"""Shamir-style share math for secure aggregation — the port's copy of the
host path of `biscotti_tpu/ops/secretshare.py`.

The reference generates each peer's shares with per-chunk scalar loops on the
CPU (ref: DistSys/kyber.go:456-482 generateMinerSecretShares,
kyber.go:579-646 createShareAndWitness, kyber.go:712-743 makePolynomialMap)
and recovers the aggregate with a gonum QR least-squares solve
(ref: kyber.go:809-867 recoverSecret/Vandermonde). Here the whole pipeline is
three array programs:

    shares   = V @ coeffsᵀ        one [S,k]·[k,C] matmul for ALL chunks
    agg      = Σ_peers shares     one sum
    coeffs'  = pinv(V) @ agg      one memoized least-squares solve

Semantics kept from the reference:
  * quantization: int(x · 10^PRECISION), truncated toward zero
    (ref: kyber.go:698-710; PRECISION=4, main.go:45)
  * polynomial chunking: POLY_SIZE=10 coefficients per chunk, last chunk
    zero-padded (ref: kyber.go:712-743; main.go:46)
  * share points: x_i = i − SHARE_OFFSET for share index i
    (ref: kyber.go:589 `minerSecretX := int64(minerPubKey - 10)`)
  * integer polynomial evaluation — *exact* here via int64 Horner/matmul,
    where the reference evaluates each term in float64 and truncates
    (kyber.go:599-602), accumulating avoidable rounding error
  * recovery: float64 Vandermonde least-squares, rounded back to int
    (ref: kyber.go:809-867)
  * per-miner striding: miner m holds share rows [m·S/M, (m+1)·S/M)
    (ref: kyber.go:205-242 extractMinerSecret)

Every function here is plain numpy on the host, exact int64 (share values
reach ~10¹³ for degree-9 chunks at PRECISION=4), as the reference's host
path is; `quantize` also takes a torch tensor. The one device seam is
`recover_coeffs`, which runs its interpolation matmul on the armed crypto
plane (`kernels.shamir_recover`); a device fault there raises. The
reference's mesh-sharded variant (`make_sharded_share_fns`) is not ported.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

PRECISION = 4  # ref: main.go:45
POLY_SIZE = 10  # ref: main.go:46
SHARE_OFFSET = 10  # ref: kyber.go:589


def total_shares_for(num_miners: int, poly_size: int = POLY_SIZE) -> int:
    """TOTAL_SHARES = ceil(2·POLY_SIZE/NUM_MINERS)·NUM_MINERS
    (ref: main.go:825)."""
    return math.ceil(2 * poly_size / num_miners) * num_miners


_I64 = np.iinfo(np.int64)


def quantize(delta, precision: int = PRECISION) -> np.ndarray:
    """float (numpy array or torch tensor, on any device) → int64 at
    10^precision, truncated toward zero like Go's int64() conversion
    (ref: kyber.go:698-710); the product is taken in float64. Outside the
    int64 range it saturates, and NaN gives 0, as the reference's XLA
    convert does (numpy's cast would give INT64_MIN with a warning).
    Share-path callers that mirror the reference's own numpy worker cast
    (peer.py:853-854, `np.trunc(...).astype(np.int64)`) keep that cast."""
    if isinstance(delta, torch.Tensor):
        delta = delta.detach().cpu().numpy()
    scaled = np.trunc(np.asarray(delta).astype(np.float64) * (10.0 ** precision))
    high, low = scaled >= 2.0 ** 63, scaled < -(2.0 ** 63)
    q = np.where(high | low | np.isnan(scaled), 0.0, scaled).astype(np.int64)
    q[high] = _I64.max
    q[low] = _I64.min
    return q


def dequantize(q, precision: int = PRECISION) -> np.ndarray:
    return np.asarray(q).astype(np.float64) / (10.0 ** precision)


def num_chunks(num_params: int, poly_size: int = POLY_SIZE) -> int:
    return -(-num_params // poly_size)


def to_chunks(q, poly_size: int = POLY_SIZE,
              chunk_multiple: int = 1) -> np.ndarray:
    """[d] int64 → [C, k] coefficient rows, zero-padded last chunk
    (ref: kyber.go:712-743). `chunk_multiple` additionally pads the CHUNK
    axis up to a multiple; zero chunks share/recover as zeros and
    from_chunks drops them."""
    q = np.asarray(q)
    d = q.shape[0]
    c = num_chunks(d, poly_size)
    if chunk_multiple > 1:
        c = -(-c // chunk_multiple) * chunk_multiple
    padded = np.zeros((c * poly_size,), q.dtype)
    padded[:d] = q
    return padded.reshape(c, poly_size)


def from_chunks(coeffs, num_params: int) -> np.ndarray:
    return np.asarray(coeffs).reshape(-1)[:num_params]


def share_xs(total_shares: int, offset: int = SHARE_OFFSET) -> np.ndarray:
    """x_i = i − offset; note x = 0 occurs at i = offset, exactly as in the
    reference (kyber.go:589)."""
    return np.arange(total_shares, dtype=np.int64) - offset


def vandermonde(xs, poly_size: int = POLY_SIZE) -> np.ndarray:
    """V[s, j] = xs[s]^j, int64 exact (|x| ≤ S, j < k → well inside int64);
    shared by share generation and recovery so the two matrices cannot
    drift apart."""
    xsn = np.asarray(xs, dtype=np.int64)
    return xsn[:, None] ** np.arange(poly_size, dtype=np.int64)[None, :]


def make_shares(q, poly_size: int = POLY_SIZE,
                total_shares: int = 2 * POLY_SIZE) -> np.ndarray:
    """[d] quantized update → [S, C] share matrix: share s of chunk c is the
    exact integer evaluation of chunk-polynomial c at x_s."""
    q = np.asarray(q)
    if q.dtype != np.int64:
        raise TypeError(f"make_shares wants int64 quantized input, got {q.dtype}")
    coeffs = to_chunks(q, poly_size)  # [C, k]
    v = vandermonde(share_xs(total_shares), poly_size)  # [S, k]
    return v @ coeffs.T  # [S, C], exact int64


def miner_rows(total_shares: int, miner_idx: int, num_miners: int) -> slice:
    """Miner m's contiguous share-row range (ref: kyber.go:205-242)."""
    per = total_shares // num_miners
    return slice(miner_idx * per, (miner_idx + 1) * per)


def aggregate_shares(peer_shares) -> np.ndarray:
    """Homomorphic aggregation: [P, S, C] → [S, C]. Works identically on a
    miner's slice [P, S/M, C] (ref: kyber.go:244-287 aggregateSecret)."""
    return np.sum(np.asarray(peer_shares), axis=0)


# Memoized Lagrange-basis (Vandermonde pseudoinverse) per share-point
# set: a live runtime rebuilds `xs` and re-factorizes the SAME [S, k]
# Vandermonde every round, so recovery collapses to one cached
# [k, S] @ [S, C] matmul — interpolation vectorized across every chunk of
# every contributor at once. Tiny (k ≤ ~10, S ≤ ~2k) and bounded:
# distinct layouts per process are the distinct (miner count,
# redundancy) configs, a handful.
_pinv_cache: dict = {}
_PINV_CACHE_MAX = 32


def _vandermonde_pinv(xs_key: tuple, poly_size: int) -> np.ndarray:
    key = (xs_key, poly_size)
    pinv = _pinv_cache.get(key)
    if pinv is None:
        if len(_pinv_cache) >= _PINV_CACHE_MAX:
            _pinv_cache.clear()
        vv = vandermonde(np.asarray(xs_key, np.int64),
                         poly_size).astype(np.float64)
        pinv = np.linalg.pinv(vv)  # [k, S]
        _pinv_cache[key] = pinv
    return pinv


def _device_kernels():
    """The armed device crypto plane (crypto/kernels) or None —
    recovery's device seam (armed by `kernels.set_enabled`)."""
    from biscotti_tpu_torch.crypto import kernels

    return kernels.active_module()


def recover_coeffs(agg_shares, xs, poly_size: int = POLY_SIZE) -> np.ndarray:
    """[S, C] aggregated shares (+ their x points) → [C, k] int64 chunk
    coefficients via float64 least-squares, rounded (ref: kyber.go:809-867 —
    the reference also recovers approximately, via mat64 QR). The solve
    rides the memoized Vandermonde pseudoinverse (the same minimum-norm
    solution lstsq produces for this full-column-rank system — distinct
    share points keep the Vandermonde full rank).

    With the device plane armed, the [k, S] @ [S, C] interpolation matmul
    runs on the armed device (kernels.shamir_recover, a float64 matmul);
    the pseudoinverse stays the SAME memoized host factorization, so both
    backends solve the identical system, and honest share sums sit
    ≥ 10¹⁰ ulp from the rounding boundary. A device fault raises."""
    agg = np.asarray(agg_shares)
    xs_key = tuple(int(x) for x in np.asarray(xs).reshape(-1))
    pinv = _vandermonde_pinv(xs_key, poly_size)
    dev = _device_kernels()
    if dev is not None:
        return dev.shamir_recover(pinv, agg, device=dev.armed_device())
    sol = pinv @ agg.astype(np.float64)  # [k, C]
    return np.round(sol.T).astype(np.int64)  # [C, k]


def recover_update(agg_shares, xs, num_params: int,
                   poly_size: int = POLY_SIZE,
                   precision: int = PRECISION) -> np.ndarray:
    """Full miner-side recovery: aggregated shares → float aggregate update
    (ref: honest.go:442-502 recoverAggregateUpdates)."""
    coeffs = recover_coeffs(agg_shares, xs, poly_size)
    flat = from_chunks(coeffs, num_params)
    return flat.astype(np.float64) / (10.0 ** precision)


# ------------------------------------------------- proactive resharing
#
# Dynamic membership (docs/MEMBERSHIP.md): when committee-relevant
# membership changes mid-epoch, surviving share-holders RE-DEAL their
# slices without any dealer — each holder sub-shares every held row as a
# fresh Shamir instance whose constant term is the row value, and
# recipients interpolate fresh shares of the same secret (two-level /
# share-of-shares resharing). Recovery across the epoch needs only the
# re-dealt material: ≥ poly_size surviving OLD rows, each re-dealt over
# ≥ poly_size NEW points. Pedersen consistency is preserved exactly —
# the sub-deal's constant-coefficient commitment must equal the
# homomorphic evaluation of the ORIGINAL coefficient commitments at the
# holder's old share point (crypto/commitments.commitment_eval_xy), so a
# holder cannot re-deal a lie about its own row.
#
# Exactness bound, same contract as the rest of this module: sub-share
# values are exact int64 and float64-recoverable, which caps the masking
# coefficients at RESHARE_COEF_BOUND (|g(x)| ≤ |row| + k·bound·|x|^(k-1)
# must stay well under 2^53). Hiding of a re-dealt row in transit is
# therefore statistical-bounded, not perfect — categorically the same
# trade the integer share pipeline itself makes (its share at x=0 IS a
# raw coefficient); the BINDING side, which soundness rests on, is the
# full-strength Pedersen check.

RESHARE_COEF_BOUND = 1 << 22


def reshare_coeffs(rows: np.ndarray, poly_size: int, seed: bytes,
                   context: bytes) -> np.ndarray:
    """Sub-share polynomial coefficients for every held row: [R, C] int64
    row values → [R, C, k] int64 where [..., 0] is the row value and
    higher coefficients are deterministic bounded-uniform masks drawn
    from SHAKE-256(seed, context) — same seed + context ⇒ the identical
    deal, so a resharing round is replayable like everything else."""
    rows = np.asarray(rows, np.int64)
    r, c = rows.shape
    k = int(poly_size)
    out = np.zeros((r, c, k), np.int64)
    out[:, :, 0] = rows
    if k > 1:
        n = r * c * (k - 1)
        raw = hashlib.shake_256(
            seed + b"biscotti-reshare" + context).digest(8 * n)
        mask = np.frombuffer(raw, dtype="<u8").astype(np.int64)
        mask = np.abs(mask) % (2 * RESHARE_COEF_BOUND + 1)
        out[:, :, 1:] = (mask - RESHARE_COEF_BOUND).reshape(r, c, k - 1)
    return out


def reshare_subshares(coeffs: np.ndarray, xs_new) -> np.ndarray:
    """Evaluate every sub-share polynomial at the new share points:
    [R, C, k] coefficients × [S'] points → [S', R, C] exact int64
    (sub[s, r, c] = g_{r,c}(x'_s)). One einsum over the Vandermonde —
    the share-generation matmul, batched across held rows."""
    coeffs = np.asarray(coeffs, np.int64)
    k = coeffs.shape[2]
    v = vandermonde(np.asarray(xs_new, np.int64), k)  # [S', k]
    return np.einsum("sk,rck->src", v, coeffs)


# Exact rational Vandermonde inverse, memoized per point set: the
# masking coefficients push sub-share magnitudes past float64's exact-
# integer range (2⁵³), so — unlike first-level recovery, whose values the
# protocol keeps small — interpolation runs in EXACT python-int
# arithmetic: inv(V) scaled to a common denominator D, one object-dtype
# matmul, and a divisibility-checked //D at the end. Recovering the FULL
# coefficient vector (not just the constant term) is what makes the
# integrality check a corruption detector: an honest deal has int64
# coefficients, while any single perturbed evaluation shifts the
# interpolant by a Lagrange basis polynomial whose leading coefficient
# 1/Π(x_j − x_m) cannot be ±1 over ≥ 3 distinct integer points — some
# recovered coefficient goes non-integer and the deal is refused loudly.
_vinv_cache: dict = {}


def _vandermonde_inv_scaled(xs_key: tuple) -> tuple:
    """(integer matrix M [k,k], common denominator D) with
    inv(vandermonde(xs)) = M / D; row 0 of M/D is the Lagrange-at-zero
    weight vector."""
    got = _vinv_cache.get(xs_key)
    if got is None:
        from fractions import Fraction
        from math import lcm

        k = len(xs_key)
        # Gauss-Jordan over exact rationals on [V | I]
        aug = [[Fraction(int(x) ** p) for p in range(k)] +
               [Fraction(int(i == j)) for j in range(k)]
               for i, x in enumerate(xs_key)]
        for col in range(k):
            piv = next(i for i in range(col, k) if aug[i][col])
            aug[col], aug[piv] = aug[piv], aug[col]
            pv = aug[col][col]
            aug[col] = [v / pv for v in aug[col]]
            for i in range(k):
                if i != col and aug[i][col]:
                    f = aug[i][col]
                    aug[i] = [a - f * b for a, b in zip(aug[i], aug[col])]
        # right half now holds inv(V): inv(V)[p][j] = coefficient p of
        # the Lagrange basis polynomial L_j
        inv = [row[k:] for row in aug]
        d = lcm(*(f.denominator for row in inv for f in row))
        m = tuple(tuple(int(f * d) for f in row) for row in inv)
        if len(_vinv_cache) >= 64:
            _vinv_cache.clear()
        _vinv_cache[xs_key] = got = (m, d)
    return got


def reshare_recover_rows(sub: np.ndarray, xs_new,
                         poly_size: int = POLY_SIZE) -> np.ndarray:
    """Interpolate every sub-share polynomial's constant term back out:
    [S', R, C] sub-shares over S' ≥ poly_size distinct points → [R, C]
    original row values, EXACT (rational interpolation over the first
    poly_size points — each point's integrity is separately proven by
    the sub-deal's VSS check, so recovery may use any k of them; the
    full recovered coefficient vector must additionally be integral,
    which refuses any singly-corrupted evaluation set loudly). This
    is what a coordinator — or any ≥ poly_size of the NEW holders
    pooling their rows — computes to reconstruct the re-dealt secret."""
    sub = np.asarray(sub, np.int64)
    s = sub.shape[0]
    if s < poly_size:
        raise ValueError(
            f"{s} sub-share points cannot determine a degree-"
            f"{poly_size - 1} sub-polynomial: resharing recovery needs "
            f">= {poly_size} new holders")
    xs = [int(x) for x in np.asarray(xs_new).reshape(-1)]
    m, den = _vandermonde_inv_scaled(tuple(xs[:poly_size]))
    r, c = sub.shape[1], sub.shape[2]
    flat = sub[:poly_size].reshape(poly_size, r * c).astype(object)
    coef = np.array(m, dtype=object) @ flat  # [k, r*c], scaled by den
    if any(int(v) % den for v in coef.reshape(-1)):
        raise ValueError("sub-shares are not evaluations of one integer "
                         "polynomial (corrupt or mismatched deal)")
    out = np.array([int(v) // den for v in coef[0]], dtype=np.int64)
    return out.reshape(r, c)
