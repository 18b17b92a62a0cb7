"""The port's op library: the fixed-width slice of the JAX package's
``ops/`` that the ported paths run (keys, gather, filter, sort, groupby
with its capped and packed-key two-level forms, inner join and its capped
form, binary and unary ops, casts, Murmur3 hashing, partitioning)."""

from . import compute, keys
from .binaryop import add, binary_op, div, eq, ge, gt, le, lt, mul, ne, sub
from .cast import cast
from .filter import filter_table, filter_table_capped
from .gather import gather_column, gather_table
from .groupby import GroupbyAgg, groupby_aggregate, groupby_aggregate_capped
from .join import inner_join, inner_join_capped
from .sort import SortKey, argsort_table, sort_table
from .unaryop import is_nan, is_not_null, is_null, unary_op

__all__ = [
    "compute", "keys", "filter_table", "filter_table_capped",
    "gather_column", "gather_table", "GroupbyAgg", "groupby_aggregate",
    "groupby_aggregate_capped", "inner_join", "inner_join_capped",
    "SortKey", "argsort_table", "sort_table", "binary_op", "add", "sub",
    "mul", "div", "eq", "ne", "lt", "le", "gt", "ge", "unary_op",
    "is_null", "is_not_null", "is_nan", "cast",
]
