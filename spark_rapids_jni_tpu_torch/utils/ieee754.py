"""float64 <-> IEEE-754 bit patterns (port of ``utils/ieee754.py``).

The JAX package computes a FLOAT64's bits with arithmetic where XLA
cannot bitcast an f64 (on a TPU), and bitcasts on the CPU backend. A CUDA
device bitcasts every dtype, so the port reads the bits with a ``view``
and applies the arithmetic codec's contract to them:

* :func:`f64_to_bits` / :func:`bits_to_f64` give the JAX arithmetic
  codec's bits: exact for normals, zeros and infinities; a subnormal
  flushes to a zero of its sign (XLA computes with DAZ/FTZ); a NaN is
  canonical (``f64_to_bits``: the positive quiet NaN with a zero payload;
  ``bits_to_f64``: the quiet NaN with a zero payload and the input's
  sign).
* :func:`float_to_bits` / :func:`bits_to_float` are a plain ``view``,
  exact for everything (the JAX package's CPU path).

Bits are ``torch.uint64`` tensors; the decoders take ``uint64`` or
``int64`` bit patterns.
"""

from __future__ import annotations

import torch

_EXP_MASK = 0x7FF
_FRAC_BITS = 52
_FRAC_MASK = (1 << _FRAC_BITS) - 1
_SIGN = -(1 << 63)  # the sign bit as an int64
_QNAN = 0x7FF8000000000000


def _as_int64(bits: torch.Tensor) -> torch.Tensor:
    return bits if bits.dtype == torch.int64 else bits.view(torch.int64)


def f64_to_bits(x: torch.Tensor) -> torch.Tensor:
    """float64 tensor -> uint64 bit patterns (subnormals flushed to a
    signed zero, NaN canonical and positive)."""
    b = x.view(torch.int64)
    exp = (b >> _FRAC_BITS) & _EXP_MASK
    b = torch.where(exp == 0, b & _SIGN, b)
    b = torch.where(torch.isnan(x), torch.full_like(b, _QNAN), b)
    return b.view(torch.uint64)


def bits_to_f64(bits: torch.Tensor) -> torch.Tensor:
    """uint64 (or int64) bit patterns -> float64 tensor (subnormals
    flushed to a signed zero, a NaN's payload canonical, its sign kept)."""
    b = _as_int64(bits)
    exp = (b >> _FRAC_BITS) & _EXP_MASK
    sign = b & _SIGN
    nan = (exp == _EXP_MASK) & ((b & _FRAC_MASK) != 0)
    b = torch.where(exp == 0, sign, b)
    b = torch.where(nan, sign | _QNAN, b)
    return b.contiguous().view(torch.float64)


def float_to_bits(x: torch.Tensor) -> torch.Tensor:
    """f64 -> u64 bits: a bitcast, exact for every input."""
    return x.contiguous().view(torch.uint64)


def bits_to_float(bits: torch.Tensor) -> torch.Tensor:
    """u64 (or i64) bits -> f64: a bitcast, exact for every input."""
    return _as_int64(bits.contiguous()).view(torch.float64)
