"""SQL type system mapped onto physical tensor dtypes.

Port of ``oceanbase_tpu/datatypes.py`` (numpy only; the port keeps its own
copy).  The physical layout is unchanged:

- integers            -> int64
- DECIMAL(p, s)       -> int64 scaled by 10**s (exact arithmetic)
- DATE                -> int32 days since 1970-01-01
- DATETIME/TIMESTAMP  -> int64 microseconds since epoch
- FLOAT/DOUBLE        -> float32/float64
- BOOL                -> bool
- CHAR/VARCHAR/TEXT   -> int32 codes into an order-preserving host
                         dictionary (sorted unique values)
- VECTOR(d)           -> [n, d] float32

NULLs ride as a separate validity array per column.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch


class TypeKind(enum.Enum):
    BOOL = "bool"
    INT = "int"            # all MySQL int widths collapse to i64
    DECIMAL = "decimal"
    FLOAT = "float"        # float32
    DOUBLE = "double"      # float64
    DATE = "date"
    DATETIME = "datetime"
    STRING = "string"
    VECTOR = "vector"      # fixed-dim float32 embedding (precision = dim)
    NULLTYPE = "null"      # type of the bare NULL literal


_NP_DTYPES = {
    TypeKind.BOOL: np.dtype(np.bool_),
    TypeKind.INT: np.dtype(np.int64),
    TypeKind.DECIMAL: np.dtype(np.int64),
    TypeKind.FLOAT: np.dtype(np.float32),
    TypeKind.DOUBLE: np.dtype(np.float64),
    TypeKind.DATE: np.dtype(np.int32),
    TypeKind.DATETIME: np.dtype(np.int64),
    TypeKind.STRING: np.dtype(np.int32),   # dictionary codes
    TypeKind.VECTOR: np.dtype(np.float32),
    TypeKind.NULLTYPE: np.dtype(np.int64),
}

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype holding numpy ``np_dtype`` values."""
    return _TORCH_DTYPES[np.dtype(np_dtype)]


@dataclass(frozen=True)
class SqlType:
    """A resolved SQL type: kind + (precision, scale) for decimals.

    ``scale`` is the power-of-ten fixed-point scale for DECIMAL; 0 otherwise.
    """

    kind: TypeKind
    precision: int = 0
    scale: int = 0
    nullable: bool = True

    # ---- constructors -------------------------------------------------
    @staticmethod
    def int_() -> "SqlType":
        return SqlType(TypeKind.INT)

    @staticmethod
    def bool_() -> "SqlType":
        return SqlType(TypeKind.BOOL)

    @staticmethod
    def decimal(precision: int = 15, scale: int = 2) -> "SqlType":
        return SqlType(TypeKind.DECIMAL, precision, scale)

    @staticmethod
    def double() -> "SqlType":
        return SqlType(TypeKind.DOUBLE)

    @staticmethod
    def float_() -> "SqlType":
        return SqlType(TypeKind.FLOAT)

    @staticmethod
    def date() -> "SqlType":
        return SqlType(TypeKind.DATE)

    @staticmethod
    def datetime() -> "SqlType":
        return SqlType(TypeKind.DATETIME)

    @staticmethod
    def string() -> "SqlType":
        return SqlType(TypeKind.STRING)

    @staticmethod
    def vector(dim: int) -> "SqlType":
        return SqlType(TypeKind.VECTOR, dim)

    @staticmethod
    def null() -> "SqlType":
        return SqlType(TypeKind.NULLTYPE)

    # ---- physical layout ----------------------------------------------
    @property
    def np_dtype(self) -> np.dtype:
        return _NP_DTYPES[self.kind]

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.np_dtype)

    @property
    def is_numeric(self) -> bool:
        return self.kind in (
            TypeKind.INT,
            TypeKind.DECIMAL,
            TypeKind.FLOAT,
            TypeKind.DOUBLE,
        )

    @property
    def is_string(self) -> bool:
        return self.kind == TypeKind.STRING

    @property
    def null_fill(self):
        """The host value a NULL lane stores behind its validity: ""
        for strings, a zero embedding for VECTOR(d), else 0."""
        if self.is_string:
            return ""
        if self.kind == TypeKind.VECTOR:
            return [0.0] * (self.precision or 1)
        return 0

    def host_zeros(self, n: int) -> np.ndarray:
        """``n`` NULL-fill lanes as a host column: an object array of ""
        for strings, [n, d] float32 for VECTOR(d), else zeros."""
        if self.is_string:
            return np.array([""] * n, dtype=object)
        if self.kind == TypeKind.VECTOR:
            return np.zeros((n, self.precision or 1), dtype=np.float32)
        return np.zeros(n, dtype=self.np_dtype)

    def host_array(self, values: list) -> np.ndarray:
        """A list of stored values (NULLs already filled) as a host
        column of this type (a VECTOR's rows stack to [n, d])."""
        if self.is_string:
            return np.array(values, dtype=object)
        if self.kind == TypeKind.VECTOR and not values:
            return self.host_zeros(0)
        return np.asarray(values, dtype=self.np_dtype)

    def __str__(self) -> str:  # pragma: no cover - debug aid
        if self.kind == TypeKind.DECIMAL:
            return f"DECIMAL({self.precision},{self.scale})"
        return self.kind.name


# ---------------------------------------------------------------------------
# Type arithmetic (result-type inference used by the expression engine)
# ---------------------------------------------------------------------------

_NUM_RANK = {
    TypeKind.INT: 0,
    TypeKind.DECIMAL: 1,
    TypeKind.FLOAT: 2,
    TypeKind.DOUBLE: 3,
}


def common_numeric(a: SqlType, b: SqlType) -> SqlType:
    """Common supertype for binary arithmetic / comparison of numerics."""
    if a.kind == TypeKind.NULLTYPE:
        return b
    if b.kind == TypeKind.NULLTYPE:
        return a
    ra, rb = _NUM_RANK[a.kind], _NUM_RANK[b.kind]
    hi = a if ra >= rb else b
    if hi.kind == TypeKind.DECIMAL:
        scale = max(a.scale, b.scale)
        return SqlType(TypeKind.DECIMAL, max(a.precision, b.precision), scale)
    return SqlType(hi.kind)


def add_result(a: SqlType, b: SqlType) -> SqlType:
    return common_numeric(a, b)


def mul_result(a: SqlType, b: SqlType) -> SqlType:
    c = common_numeric(a, b)
    if c.kind == TypeKind.DECIMAL:
        # exact: scales add under multiplication of scaled ints
        return SqlType(TypeKind.DECIMAL, a.precision + b.precision,
                       a.scale + b.scale)
    return c


def div_result(a: SqlType, b: SqlType) -> SqlType:
    # decimal / int division yields DOUBLE on the device plane
    c = common_numeric(a, b)
    if c.kind in (TypeKind.DECIMAL, TypeKind.INT):
        return SqlType(TypeKind.DOUBLE)
    return c


DATE_EPOCH = np.datetime64("1970-01-01", "D")


def date_to_days(s: str) -> int:
    """'1994-01-01' -> int32 days since epoch."""
    return int((np.datetime64(s, "D") - DATE_EPOCH).astype(np.int64))


def days_to_date(d: int) -> str:
    return str(DATE_EPOCH + np.timedelta64(int(d), "D"))
