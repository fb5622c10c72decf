"""Exact integer bit-math primitives for conformance-critical device code.

The WordPiece trainer must reproduce Python's float semantics for
``score = pair_freq / (freq_a * freq_b)`` (reference: source/wordpiece.py:84-87)
including *which pairs compare equal after rounding to double* — the
tie-break (`max` over dict insertion order, source/wordpiece.py:92) is only
reached on exact double equality, so the selection is wrong unless the
scores are the correctly-rounded IEEE doubles.

The bit pattern of ``c / d`` is computed directly with exact i64 long
division rather than an f64 divide: this was built for a backend whose
emulated f64 divide was not correctly rounded, and whether XLA:GPU's
f64 divide is correctly rounded is not yet checked, so the integer
scorer stays the one source of truth on every backend. The bit
pattern of a positive double is monotone in its value, so the result is a
sortable i64 selection key.

Two dividers share the rounding tail:

- :func:`div_double_bits` — narrow domain: 1 <= c < 2**33,
  1 <= d < 2**53 (covers any corpus with < 2**26 total tokens — fa*fb
  stays an exact i64).
- :func:`div_double_bits_wide` — the denominator is a 128-bit integer in
  two base-2**53 limbs (see :func:`mul_53x53`), 1 <= c <= d < 2**106.
  CPython's ``int.__truediv__`` is correctly rounded at *any* operand
  size, so this reproduces the reference score for corpora up to ~2**52
  total tokens (fa, fb < 2**52 ⇒ fa*fb < 2**104).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

MASK53 = (1 << 53) - 1


def bitlen(x: jax.Array) -> jax.Array:
    """floor(log2(x)) + 1 for positive i64 ``x``, elementwise."""
    l = jnp.zeros_like(x)
    v = x
    for sh in (32, 16, 8, 4, 2, 1):
        t = v >> sh
        take = t > 0
        v = jnp.where(take, t, v)
        l = l + jnp.where(take, sh, 0)
    return l + 1


def _round_q55(q: jax.Array, e0: jax.Array,
               rem_nonzero: jax.Array) -> jax.Array:
    """Round-half-to-even packing shared by both dividers.

    ``q`` = floor(value * 2^(55 - e0)) in [2^54, 2^56) where ``value`` is
    the exact quotient with bit-length estimate ``e0`` (value in
    [2^(e0-1), 2^(e0+1))); ``rem_nonzero`` marks an inexact division.
    Returns the IEEE-754 binary64 bit pattern as i64.
    """
    big = q >= (1 << 55)                 # true exponent is e0, not e0-1
    e = e0 - 1 + big.astype(jnp.int64)
    dropped = jnp.where(big, q & 1, 0)
    q2 = q >> big.astype(jnp.int64)      # floor(value * 2^(54-e)), 55 bits

    m_floor = q2 >> 2                    # 53-bit mantissa incl. implicit bit
    round_bit = (q2 >> 1) & 1
    sticky = ((q2 & 1) | dropped | rem_nonzero.astype(jnp.int64)) != 0
    round_up = (round_bit != 0) & (sticky | ((m_floor & 1) != 0))
    m = m_floor + round_up.astype(jnp.int64)

    # Mantissa overflow from rounding: 2^53 -> 2^52 with exponent bump.
    ovf = m == (1 << 53)
    m = jnp.where(ovf, jnp.int64(1) << 52, m)
    e = e + ovf.astype(jnp.int64)

    return ((e + 1023) << 52) | (m & ((jnp.int64(1) << 52) - 1))


def div_double_bits(c: jax.Array, d: jax.Array) -> jax.Array:
    """IEEE-754 binary64 bit pattern of ``c / d`` as i64, elementwise.

    ``c`` and ``d`` are positive i64 in the documented narrow domain. The
    result equals ``float(c) / float(d)`` as computed by CPython (correctly
    rounded, round-half-to-even), viewed as an i64. Monotone in the value.
    """
    c = c.astype(jnp.int64)
    d = d.astype(jnp.int64)
    e0 = bitlen(c) - bitlen(d)          # c/d in [2^(e0-1), 2^(e0+1))
    s = 55 - e0                          # target: Q = floor(c*2^s/d) in [2^54, 2^56)

    q = c // d
    r = c - q * d
    # Chunked long division: shift the remainder in <=10-bit chunks
    # (r < d < 2^53, so r << 10 cannot overflow i64). s <= 107, so 11
    # chunks always suffice; lanes with smaller s shift by 0 in the tail.
    for j in range(11):
        k = jnp.clip(s - 10 * j, 0, 10)
        r2 = r << k
        qc = r2 // d
        r = r2 - qc * d
        q = (q << k) + qc

    return _round_q55(q, e0, r != 0)


def mul_53x53(a: jax.Array, b: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Exact 128-bit product of two i64 values < 2**53, elementwise.

    Returns base-2**53 limbs ``(hi, lo)``: ``a * b == hi * 2**53 + lo``
    with ``0 <= lo < 2**53`` and ``hi < 2**53``. All intermediates stay
    below 2**63 (27/26-bit half products).
    """
    a = a.astype(jnp.int64)
    b = b.astype(jnp.int64)
    a1, a0 = a >> 27, a & ((1 << 27) - 1)   # a1 < 2^26
    b1, b0 = b >> 27, b & ((1 << 27) - 1)
    hh = a1 * b1                             # < 2^52
    hl = a1 * b0 + a0 * b1                   # < 2^54
    ll = a0 * b0                             # < 2^54
    # value = hh*2^54 + hl*2^27 + ll; split hl*2^27 across the limbs
    # (27 + 26 = 53): hl*2^27 = (hl >> 26)*2^53 + (hl & (2^26-1))*2^27.
    lo_raw = ll + ((hl & ((1 << 26) - 1)) << 27)   # < 2^55
    hi = (hh << 1) + (hl >> 26) + (lo_raw >> 53)
    return hi, lo_raw & MASK53


def bitlen128(hi: jax.Array, lo: jax.Array) -> jax.Array:
    """Bit length of ``hi * 2**53 + lo`` (positive), elementwise."""
    return jnp.where(hi > 0, bitlen(hi) + 53, bitlen(lo))


def div_double_bits_wide(c: jax.Array, d_hi: jax.Array,
                         d_lo: jax.Array) -> jax.Array:
    """IEEE-754 binary64 bit pattern of ``c / d`` for a 128-bit ``d``.

    ``d = d_hi * 2**53 + d_lo`` (limbs from :func:`mul_53x53`), with
    ``1 <= c <= d < 2**106`` and ``c < 2**53`` — the WordPiece score
    domain for corpora up to ~2**52 total tokens (the pair count never
    exceeds either symbol frequency, so c <= fa <= fa*fb = d). Equals
    CPython's arbitrary-precision ``c / d`` bit-for-bit (long_true_divide
    is correctly rounded at any operand size).

    Method: align ``c`` to ``d``'s bit length (one variable limb shift),
    then 55 restoring-division steps produce Q = floor(c * 2^(55-e0) / d)
    in (2^54, 2^56) plus a sticky remainder; the rounding tail is shared
    with :func:`div_double_bits`.
    """
    c = c.astype(jnp.int64)
    d_hi = d_hi.astype(jnp.int64)
    d_lo = d_lo.astype(jnp.int64)
    lc = bitlen(c)
    ld = bitlen128(d_hi, d_lo)
    e0 = lc - ld                         # <= 0 since c <= d
    t = ld - lc                          # align shift, 0..105

    # N = c << t as base-2^53 limbs; N has bit length ld so it fits.
    tq = t >= 53
    t0 = jnp.clip(t, 0, 52)              # shift within the low limb
    t1 = jnp.clip(t - 53, 0, 52)         # shift landing in the high limb
    n_hi0 = c >> (53 - t0)
    n_lo0 = (c & ((jnp.int64(1) << (53 - t0)) - 1)) << t0
    n_hi1 = c << t1                      # bitlen(c) + t1 = ld - 53 <= 53
    n_hi = jnp.where(tq, n_hi1, n_hi0)
    n_lo = jnp.where(tq, jnp.int64(0), n_lo0)

    def sub_if_ge(rhi, rlo, q):
        """One restoring step (no doubling): R ∈ [0, 2d) → [0, d)."""
        ge = (rhi > d_hi) | ((rhi == d_hi) & (rlo >= d_lo))
        lo_sub = rlo - d_lo
        borrow = (lo_sub < 0).astype(jnp.int64)
        lo_sub = lo_sub + (borrow << 53)
        hi_sub = rhi - d_hi - borrow
        rhi = jnp.where(ge, hi_sub, rhi)
        rlo = jnp.where(ge, lo_sub, rlo)
        return rhi, rlo, (q << 1) | ge.astype(jnp.int64)

    def step(_, st):
        rhi, rlo, q = st
        # R <<= 1 across limbs (rhi < 2^53 pre-shift: R < d < 2^106).
        rhi = (rhi << 1) | (rlo >> 52)
        rlo = (rlo << 1) & MASK53
        return sub_if_ge(rhi, rlo, q)

    # N shares d's bit length but may still be >= d (N < 2^ld <= 2d), so
    # the leading quotient bit comes from one subtract before any doubling;
    # after it the loop invariant R < d holds.
    init = sub_if_ge(n_hi, n_lo, jnp.zeros_like(c))
    rhi, rlo, q = jax.lax.fori_loop(0, 55, step, init)
    return _round_q55(q, e0, (rhi | rlo) != 0)
