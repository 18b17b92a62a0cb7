"""The port's op library: the fixed-width slice of the JAX package's
``ops/`` that the ported paths run (keys, gather, filter, sort, groupby
with its packed-key two-level form, inner join, Murmur3 hashing,
partitioning)."""

from . import compute, keys
from .filter import filter_table, filter_table_capped
from .gather import gather_column, gather_table
from .groupby import GroupbyAgg, groupby_aggregate
from .join import inner_join
from .sort import SortKey, argsort_table, sort_table

__all__ = [
    "compute", "keys", "filter_table", "filter_table_capped",
    "gather_column", "gather_table", "GroupbyAgg", "groupby_aggregate",
    "inner_join", "SortKey", "argsort_table", "sort_table",
]
