"""Limb-decomposed Ed25519 base-field arithmetic as torch int64 ops
(counterpart of `biscotti_tpu/crypto/kernels/field.py`).

A field element of GF(p), p = 2²⁵⁵ − 19, is **16 radix-2¹⁶ limbs**, an
int64 tensor [..., 16], with the reference's *lazy* carries: ops keep
limbs inside a loose `< 2¹⁷` invariant, and only `canonical` propagates
exactly. The bounds are the reference's:

    inputs  < 2¹⁷ per limb
    products < 2³⁴, convolution sum of ≤ 16 terms < 2³⁸
    2²⁵⁶ ≡ 38 fold:  lo + 38·hi < 2³⁸·39 < 2⁴⁴  — comfortably int64
    two carry passes → every limb back under 2¹⁷

Every op follows the reference formula for formula and carry for carry, so
the port's loose limbs equal the reference's bit for bit, not just mod p.
One thing differs: the reference routes the 16×16 outer product to its 31
convolution diagonals with an int64 matmul against a constant [256, 31]
0/1 matrix, and PyTorch's CUDA matmul has no int64 kernel. `fmul` sums the
diagonals elementwise instead (the outer product, each row padded to 32
and read back with a row stride of 31, puts diagonal i + j in column
i + j). The sums are exact integers, so the order of addition does not
change a bit.

`>>` on an int64 tensor is an arithmetic shift and `&` works in two's
complement, as in jnp, so the carry passes stay exact for the ≥ −2¹⁶ limbs
a subtraction can transiently produce. The shapes are polymorphic over
leading batch dimensions. The host-side packing helpers (python ints,
little-endian bytes ↔ limb arrays) are numpy, copied from the reference.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from biscotti_tpu_torch.crypto import ed25519 as ed

LIMBS = 16
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1

P = ed.P
Q = ed.Q

# 2²⁵⁶ mod p = 38 — the high-half fold constant
FOLD = 38


def int_to_limbs(v: int) -> np.ndarray:
    """One canonical field element → (16,) int32 limb vector."""
    b = (int(v) % P).to_bytes(32, "little")
    return np.frombuffer(b, dtype="<u2").astype(np.int32)


def ints_to_limbs(vals: Sequence[int]) -> np.ndarray:
    """[n] canonical field elements → [n, 16] int32 limbs (one bytes
    join, no per-limb python arithmetic)."""
    blob = b"".join((int(v) % P).to_bytes(32, "little") for v in vals)
    return (np.frombuffer(blob, dtype="<u2")
            .reshape(len(vals), LIMBS).astype(np.int32))


def limbs_to_int(arr) -> int:
    """(…,16) limb vector (any non-negative magnitudes) → python int.
    NOT reduced mod p — callers reduce when they need the field value."""
    a = np.asarray(arr, dtype=object).reshape(-1)
    return sum(int(a[i]) << (LIMB_BITS * i) for i in range(len(a)))


def bytes_to_limbs(buf: bytes, n: int) -> np.ndarray:
    """n packed 32-byte little-endian values → [n, 16] int32 limbs.
    No canonicity check — feed the result to `lt_p` for that."""
    if len(buf) != 32 * n:
        raise ValueError("buffer length mismatch")
    return (np.frombuffer(buf, dtype="<u2")
            .reshape(n, LIMBS).astype(np.int32))


# constant limb tables (numpy, as in the reference; `const` puts them on a
# device). P itself must bypass int_to_limbs — that helper canonicalizes
# mod p, which would turn the modulus into the zero vector.
P_LIMBS = np.frombuffer(P.to_bytes(32, "little"),
                        dtype="<u2").astype(np.int64)
# 8p as 16 NON-NORMALIZED limbs: 4 × (2²⁵⁶ − 38) limb-wise. Every limb is
# ≥ 2¹⁸ − 152 > 2¹⁷, so `a + EIGHT_P - b` never goes negative under the
# loose < 2¹⁷ limb invariant.
EIGHT_P = (np.array([0xFFFF - 37] + [0xFFFF] * 15, dtype=np.int64) * 4)
D_LIMBS = int_to_limbs(ed.D).astype(np.int64)
D2_LIMBS = int_to_limbs(2 * ed.D % P).astype(np.int64)
ONE_LIMBS = int_to_limbs(1).astype(np.int64)
ZERO_LIMBS = np.zeros(LIMBS, dtype=np.int64)

_CONSTS = {"P_LIMBS": P_LIMBS, "EIGHT_P": EIGHT_P, "D_LIMBS": D_LIMBS,
           "D2_LIMBS": D2_LIMBS, "ONE_LIMBS": ONE_LIMBS,
           "ZERO_LIMBS": ZERO_LIMBS}


@functools.lru_cache(maxsize=None)
def const(name: str, device: torch.device) -> torch.Tensor:
    """The named limb constant (`P_LIMBS`, `EIGHT_P`, `D_LIMBS`,
    `D2_LIMBS`, `ONE_LIMBS`, `ZERO_LIMBS`) as an int64 tensor on
    `device`, made once per device."""
    return torch.as_tensor(_CONSTS[name], dtype=torch.int64, device=device)


def carry(x: torch.Tensor, passes: int = 2) -> torch.Tensor:
    """PARALLEL (carry-save) lazy-carry passes with the 2²⁵⁶ ≡ 38 top
    fold: every pass is four vector ops (split, mask, rotate-with-fold,
    add) with no sequential limb chain. A pass moves each carry one limb;
    it does NOT fully propagate, which the loose `< 2¹⁷` invariant
    tolerates:

        post-multiply v < 2⁴⁴  → pass 1 carries < 2²⁸, limbs < 2¹⁶+2²⁸
                               → pass 2 carries < 2¹³, limbs < 2¹⁶+2¹³ ✓
        post-add/sub  v < 2¹⁹  → one pass leaves limbs < 2¹⁶+2⁹ ✓
    """
    for _ in range(passes):
        c = x >> LIMB_BITS
        rot = torch.cat([FOLD * c[..., LIMBS - 1:], c[..., :LIMBS - 1]],
                        dim=-1)
        x = (x & MASK) + rot
    return x


def carry_seq(x: torch.Tensor, passes: int = 2) -> torch.Tensor:
    """Sequential full-propagation carry chains (the slow exact form the
    canonical representative needs). Arithmetic shifts make the chain
    correct for (slightly) negative limbs too."""
    for _ in range(passes):
        out = []
        c = torch.zeros_like(x[..., 0])
        for i in range(LIMBS):
            v = x[..., i] + c
            c = v >> LIMB_BITS
            out.append(v & MASK)
        out[0] = out[0] + FOLD * c  # a fresh tensor: nothing shared changes
        x = torch.stack(out, dim=-1)
    return x


def _diagonal_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 31] sums of the 16×16 outer product along i + j — the
    reference's `prod.reshape(..., 256) @ CONV`, elementwise. Row i of the
    outer product padded to 32 columns and read back with a row stride of
    31 lands element j in column i + j; the padding fills the rest."""
    prod = a[..., :, None] * b[..., None, :]  # [..., 16, 16] < 2^34
    batch = prod.shape[:-2]
    padded = torch.nn.functional.pad(prod, (0, LIMBS))  # [..., 16, 32]
    flat = padded.reshape(*batch, LIMBS * 2 * LIMBS)
    skew = flat[..., :LIMBS * (2 * LIMBS - 1)].reshape(*batch, LIMBS,
                                                       2 * LIMBS - 1)
    return skew.sum(dim=-2)


def fmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field multiply of two loose (< 2¹⁷ limbs) elements; returns a
    loose element. Outer product, diagonal sums, fold, two carries."""
    conv = _diagonal_sums(a, b)  # [..., 31]
    lo = conv[..., :LIMBS]
    hi = torch.cat([conv[..., LIMBS:], torch.zeros_like(conv[..., :1])],
                   dim=-1)  # pad position 31
    return carry(lo + FOLD * hi, passes=2)


def fadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry(a + b, passes=1)


def fsub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a − b mod p via the non-normalized 8p limb constant (keeps every
    intermediate limb non-negative under the loose invariant)."""
    return carry(a + const("EIGHT_P", a.device) - b, passes=1)


def _cond_sub_p(x: torch.Tensor) -> torch.Tensor:
    """One conditional canonical-form subtraction: x − p when x ≥ p.
    Requires properly carried limbs (< 2¹⁶)."""
    outs = []
    borrow = torch.zeros_like(x[..., 0])
    for i in range(LIMBS):
        v = x[..., i] - int(P_LIMBS[i]) - borrow
        borrow = (v < 0).to(v.dtype)
        outs.append(v + (borrow << LIMB_BITS))
    sub = torch.stack(outs, dim=-1)
    keep = (borrow > 0)[..., None]  # final borrow → x < p → keep x
    return torch.where(keep, x, sub)


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Exact canonical representative (< p, limbs < 2¹⁶) of a loose
    element — the form equality and on-curve verdicts compare. Four
    sequential passes: three settle the loose magnitudes, the fourth
    retires the ≤ 38 residue the top fold can leave on limb 0, so
    `_cond_sub_p`'s borrow logic always sees properly carried limbs."""
    x = carry_seq(x, passes=4)
    x = _cond_sub_p(x)
    return _cond_sub_p(x)


def is_zero(x: torch.Tensor) -> torch.Tensor:
    """True where the loose element ≡ 0 mod p. Returns a boolean with
    the input's batch shape."""
    return (canonical(x) == 0).all(dim=-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (canonical(a) == canonical(b)).all(dim=-1)


def lt_p(x: torch.Tensor) -> torch.Tensor:
    """Canonicity test for *carried* (< 2¹⁶ limbs) values: strict x < p,
    matching the pure-python loaders' rejection of non-canonical wire
    coordinates."""
    lt = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    eq_so_far = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
    for i in range(LIMBS - 1, -1, -1):
        pi = int(P_LIMBS[i])
        lt = lt | (eq_so_far & (x[..., i] < pi))
        eq_so_far = eq_so_far & (x[..., i] == pi)
    return lt


def scalars_to_bits(scalars: Sequence[int], bits: int = 256,
                    msb_first: bool = True) -> np.ndarray:
    """[n] non-negative ints (< 2^bits) → [n, bits] uint8 bit matrix.
    MSB-first is the double-and-add order; LSB-first feeds the fixed-base
    table walk."""
    n = len(scalars)
    blob = b"".join(int(s).to_bytes(bits // 8, "little") for s in scalars)
    by = np.frombuffer(blob, dtype=np.uint8).reshape(n, bits // 8)
    b = np.unpackbits(by, axis=1, bitorder="little")  # [n, bits] LSB-first
    return b[:, ::-1].copy() if msb_first else b


__all__: List[str] = [
    "LIMBS", "LIMB_BITS", "MASK", "P", "Q", "FOLD",
    "int_to_limbs", "ints_to_limbs", "limbs_to_int", "bytes_to_limbs",
    "P_LIMBS", "EIGHT_P", "D_LIMBS", "D2_LIMBS", "ONE_LIMBS", "ZERO_LIMBS",
    "const", "carry", "carry_seq", "fmul", "fadd", "fsub", "canonical",
    "is_zero", "eq", "lt_p", "scalars_to_bits",
]
