"""Columnar type system of the PyTorch port.

The same (type id, decimal scale) pair as the JAX package's ``dtype.py``
— the wire format the reference marshals across JNI as two parallel int
arrays (RowConversionJni.cpp:56-61). Type ids, row widths and the wire
helpers are a copy, so the port never imports the JAX package.

Storage rule: every fixed-width type maps to one torch dtype of the same
width. FLOAT64 is carried as its IEEE-754 bit pattern in an ``int64``
tensor — the same bytes the JAX package keeps in ``uint64`` — so the row
transpose and the wire move bits, never values. Unsigned types use
torch's unsigned dtypes, which support storage, views and copies but
little arithmetic on the CPU.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class TypeId(enum.IntEnum):
    """Native ids of the cudf 22.04 type enum (RowConversion.java:119)."""

    EMPTY = 0
    INT8 = 1
    INT16 = 2
    INT32 = 3
    INT64 = 4
    UINT8 = 5
    UINT16 = 6
    UINT32 = 7
    UINT64 = 8
    FLOAT32 = 9
    FLOAT64 = 10
    BOOL8 = 11
    TIMESTAMP_DAYS = 12
    TIMESTAMP_SECONDS = 13
    TIMESTAMP_MILLISECONDS = 14
    TIMESTAMP_MICROSECONDS = 15
    TIMESTAMP_NANOSECONDS = 16
    DURATION_DAYS = 17
    DURATION_SECONDS = 18
    DURATION_MILLISECONDS = 19
    DURATION_MICROSECONDS = 20
    DURATION_NANOSECONDS = 21
    DICTIONARY32 = 22
    STRING = 23
    LIST = 24
    DECIMAL32 = 25
    DECIMAL64 = 26
    DECIMAL128 = 27
    STRUCT = 28


# Packed-row width in bytes of each fixed-width type (row_conversion.cu:432-456).
_WIDTHS = {
    TypeId.INT8: 1,
    TypeId.INT16: 2,
    TypeId.INT32: 4,
    TypeId.INT64: 8,
    TypeId.UINT8: 1,
    TypeId.UINT16: 2,
    TypeId.UINT32: 4,
    TypeId.UINT64: 8,
    TypeId.FLOAT32: 4,
    TypeId.FLOAT64: 8,
    TypeId.BOOL8: 1,
    TypeId.TIMESTAMP_DAYS: 4,
    TypeId.TIMESTAMP_SECONDS: 8,
    TypeId.TIMESTAMP_MILLISECONDS: 8,
    TypeId.TIMESTAMP_MICROSECONDS: 8,
    TypeId.TIMESTAMP_NANOSECONDS: 8,
    TypeId.DURATION_DAYS: 4,
    TypeId.DURATION_SECONDS: 8,
    TypeId.DURATION_MILLISECONDS: 8,
    TypeId.DURATION_MICROSECONDS: 8,
    TypeId.DURATION_NANOSECONDS: 8,
    TypeId.DICTIONARY32: 4,
    TypeId.DECIMAL32: 4,
    TypeId.DECIMAL64: 8,
    TypeId.DECIMAL128: 16,
}

# torch storage dtype of each fixed-width type id (FLOAT64: bit pattern;
# DECIMAL128: (n, 2) int64 little-endian limbs [lo, hi]).
_STORAGE = {
    TypeId.INT8: torch.int8,
    TypeId.INT16: torch.int16,
    TypeId.INT32: torch.int32,
    TypeId.INT64: torch.int64,
    TypeId.UINT8: torch.uint8,
    TypeId.UINT16: torch.uint16,
    TypeId.UINT32: torch.uint32,
    TypeId.UINT64: torch.uint64,
    TypeId.FLOAT32: torch.float32,
    TypeId.FLOAT64: torch.int64,
    TypeId.BOOL8: torch.bool,
    TypeId.TIMESTAMP_DAYS: torch.int32,
    TypeId.TIMESTAMP_SECONDS: torch.int64,
    TypeId.TIMESTAMP_MILLISECONDS: torch.int64,
    TypeId.TIMESTAMP_MICROSECONDS: torch.int64,
    TypeId.TIMESTAMP_NANOSECONDS: torch.int64,
    TypeId.DURATION_DAYS: torch.int32,
    TypeId.DURATION_SECONDS: torch.int64,
    TypeId.DURATION_MILLISECONDS: torch.int64,
    TypeId.DURATION_MICROSECONDS: torch.int64,
    TypeId.DURATION_NANOSECONDS: torch.int64,
    TypeId.DICTIONARY32: torch.int32,
    TypeId.DECIMAL32: torch.int32,
    TypeId.DECIMAL64: torch.int64,
    TypeId.DECIMAL128: torch.int64,
}

# numpy dtype of the wire / host buffer of each fixed-width type: the JAX
# package's storage dtype, so host buffers of both packages hold equal bytes
_HOST_NP = {
    TypeId.INT8: np.int8,
    TypeId.INT16: np.int16,
    TypeId.INT32: np.int32,
    TypeId.INT64: np.int64,
    TypeId.UINT8: np.uint8,
    TypeId.UINT16: np.uint16,
    TypeId.UINT32: np.uint32,
    TypeId.UINT64: np.uint64,
    TypeId.FLOAT32: np.float32,
    TypeId.FLOAT64: np.uint64,
    TypeId.BOOL8: np.bool_,
    TypeId.TIMESTAMP_DAYS: np.int32,
    TypeId.TIMESTAMP_SECONDS: np.int64,
    TypeId.TIMESTAMP_MILLISECONDS: np.int64,
    TypeId.TIMESTAMP_MICROSECONDS: np.int64,
    TypeId.TIMESTAMP_NANOSECONDS: np.int64,
    TypeId.DURATION_DAYS: np.int32,
    TypeId.DURATION_SECONDS: np.int64,
    TypeId.DURATION_MILLISECONDS: np.int64,
    TypeId.DURATION_MICROSECONDS: np.int64,
    TypeId.DURATION_NANOSECONDS: np.int64,
    TypeId.DICTIONARY32: np.int32,
    TypeId.DECIMAL32: np.int32,
    TypeId.DECIMAL64: np.int64,
    TypeId.DECIMAL128: np.uint64,
}

_SIGNED_INT_IDS = frozenset(
    {TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64}
)
_UNSIGNED_INT_IDS = frozenset(
    {TypeId.UINT8, TypeId.UINT16, TypeId.UINT32, TypeId.UINT64}
)
_FLOAT_IDS = frozenset({TypeId.FLOAT32, TypeId.FLOAT64})
_DECIMAL_IDS = frozenset(
    {TypeId.DECIMAL32, TypeId.DECIMAL64, TypeId.DECIMAL128}
)
_TIMESTAMP_IDS = frozenset(
    {TypeId.TIMESTAMP_DAYS, TypeId.TIMESTAMP_SECONDS,
     TypeId.TIMESTAMP_MILLISECONDS, TypeId.TIMESTAMP_MICROSECONDS,
     TypeId.TIMESTAMP_NANOSECONDS}
)
_DURATION_IDS = frozenset(
    {TypeId.DURATION_DAYS, TypeId.DURATION_SECONDS,
     TypeId.DURATION_MILLISECONDS, TypeId.DURATION_MICROSECONDS,
     TypeId.DURATION_NANOSECONDS}
)


@dataclasses.dataclass(frozen=True)
class DType:
    """A columnar data type: (type id, decimal scale), cudf's convention
    (the stored integer x represents ``x * 10**scale``)."""

    id: TypeId
    scale: int = 0

    def __post_init__(self):
        if self.scale != 0 and self.id not in _DECIMAL_IDS:
            raise ValueError(f"non-zero scale on non-decimal type {self.id!r}")

    @property
    def is_fixed_width(self) -> bool:
        return self.id in _WIDTHS

    @property
    def is_decimal(self) -> bool:
        return self.id in _DECIMAL_IDS

    @property
    def is_unsigned(self) -> bool:
        return self.id in _UNSIGNED_INT_IDS

    @property
    def is_integer(self) -> bool:
        return self.id in _SIGNED_INT_IDS or self.id in _UNSIGNED_INT_IDS

    @property
    def is_floating(self) -> bool:
        return self.id in _FLOAT_IDS

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_floating or self.is_decimal

    @property
    def is_boolean(self) -> bool:
        return self.id == TypeId.BOOL8

    @property
    def is_timestamp(self) -> bool:
        return self.id in _TIMESTAMP_IDS

    @property
    def is_duration(self) -> bool:
        return self.id in _DURATION_IDS

    @property
    def is_string(self) -> bool:
        return self.id == TypeId.STRING

    @property
    def itemsize(self) -> int:
        """Width in bytes in the packed row format (cudf ``size_of``)."""
        try:
            return _WIDTHS[self.id]
        except KeyError:
            raise TypeError(f"{self.id!r} is not fixed-width") from None

    @property
    def storage_dtype(self) -> torch.dtype:
        """The torch dtype of the tensor backing this column."""
        try:
            return _STORAGE[self.id]
        except KeyError:
            raise TypeError(f"{self.id!r} has no fixed-width storage") from None

    @property
    def host_dtype(self) -> np.dtype:
        """The numpy dtype of this column's host buffer (the JAX package's
        storage dtype: FLOAT64 as uint64 bits)."""
        try:
            return np.dtype(_HOST_NP[self.id])
        except KeyError:
            raise TypeError(f"{self.id!r} has no fixed-width storage") from None

    @property
    def value_dtype(self) -> np.dtype:
        """The numpy dtype of this column's arithmetic values (the JAX
        package's ``device_dtype``): the host dtype, FLOAT64 as float64."""
        if self.id == TypeId.DECIMAL128:
            raise TypeError("DECIMAL128 has no scalar value dtype")
        if self.id == TypeId.FLOAT64:
            return np.dtype(np.float64)
        return self.host_dtype

    def to_wire(self) -> tuple[int, int]:
        """(native type id, scale) — the JNI int-array pair."""
        return int(self.id), int(self.scale)

    @staticmethod
    def from_wire(type_id: int, scale: int = 0) -> "DType":
        return DType(TypeId(type_id), scale)

    def __repr__(self) -> str:
        if self.is_decimal:
            return f"DType({self.id.name}, scale={self.scale})"
        return f"DType({self.id.name})"


INT8 = DType(TypeId.INT8)
INT16 = DType(TypeId.INT16)
INT32 = DType(TypeId.INT32)
INT64 = DType(TypeId.INT64)
UINT8 = DType(TypeId.UINT8)
UINT16 = DType(TypeId.UINT16)
UINT32 = DType(TypeId.UINT32)
UINT64 = DType(TypeId.UINT64)
FLOAT32 = DType(TypeId.FLOAT32)
FLOAT64 = DType(TypeId.FLOAT64)
BOOL8 = DType(TypeId.BOOL8)
LIST = DType(TypeId.LIST)
STRING = DType(TypeId.STRING)
STRUCT = DType(TypeId.STRUCT)
TIMESTAMP_DAYS = DType(TypeId.TIMESTAMP_DAYS)
TIMESTAMP_SECONDS = DType(TypeId.TIMESTAMP_SECONDS)
TIMESTAMP_MILLISECONDS = DType(TypeId.TIMESTAMP_MILLISECONDS)
TIMESTAMP_MICROSECONDS = DType(TypeId.TIMESTAMP_MICROSECONDS)
TIMESTAMP_NANOSECONDS = DType(TypeId.TIMESTAMP_NANOSECONDS)
DURATION_DAYS = DType(TypeId.DURATION_DAYS)
DURATION_SECONDS = DType(TypeId.DURATION_SECONDS)
DURATION_MILLISECONDS = DType(TypeId.DURATION_MILLISECONDS)
DURATION_MICROSECONDS = DType(TypeId.DURATION_MICROSECONDS)
DURATION_NANOSECONDS = DType(TypeId.DURATION_NANOSECONDS)


def decimal32(scale: int) -> DType:
    return DType(TypeId.DECIMAL32, scale)


def decimal64(scale: int) -> DType:
    return DType(TypeId.DECIMAL64, scale)


def decimal128(scale: int) -> DType:
    return DType(TypeId.DECIMAL128, scale)


_NP_TO_TYPEID = {
    np.dtype(np.int8): TypeId.INT8,
    np.dtype(np.int16): TypeId.INT16,
    np.dtype(np.int32): TypeId.INT32,
    np.dtype(np.int64): TypeId.INT64,
    np.dtype(np.uint8): TypeId.UINT8,
    np.dtype(np.uint16): TypeId.UINT16,
    np.dtype(np.uint32): TypeId.UINT32,
    np.dtype(np.uint64): TypeId.UINT64,
    np.dtype(np.float32): TypeId.FLOAT32,
    np.dtype(np.float64): TypeId.FLOAT64,
    np.dtype(np.bool_): TypeId.BOOL8,
}


def from_numpy_dtype(np_dtype) -> DType:
    """Infer a DType from a numpy dtype (non-decimal, non-temporal)."""
    try:
        return DType(_NP_TO_TYPEID[np.dtype(np_dtype)])
    except KeyError:
        raise TypeError(f"unsupported numpy dtype {np_dtype}") from None


def common_numeric_dtype(a: DType, b: DType) -> DType:
    """Binary-op type promotion of plain numerics (numpy's rules on the
    value dtypes; decimals take the wider storage and the finer scale)."""
    if a.is_decimal or b.is_decimal:
        wid = max(a.itemsize, b.itemsize)
        scale = min(a.scale if a.is_decimal else 0,
                    b.scale if b.is_decimal else 0)
        return DType(TypeId.DECIMAL64 if wid >= 8 else TypeId.DECIMAL32, scale)
    return from_numpy_dtype(np.promote_types(a.value_dtype, b.value_dtype))


# LIST children whose storage dtype maps back to one type id; the child
# type of a LIST column is read off its data tensor's dtype
_TORCH_TO_LIST_CHILD = {
    torch.int8: TypeId.INT8,
    torch.int16: TypeId.INT16,
    torch.int32: TypeId.INT32,
    torch.int64: TypeId.INT64,
    torch.uint8: TypeId.UINT8,
    torch.uint16: TypeId.UINT16,
    torch.uint32: TypeId.UINT32,
    torch.uint64: TypeId.UINT64,
    torch.float32: TypeId.FLOAT32,
    torch.bool: TypeId.BOOL8,
}


def list_child_from_storage(t: torch.dtype) -> DType:
    try:
        return DType(_TORCH_TO_LIST_CHILD[t])
    except KeyError:
        raise TypeError(f"no LIST child type for storage {t}") from None
