"""The port's op library: the JAX package's ``ops/`` that the dispatch
plane reaches (keys, gather, filter, sort, groupby with its capped and
packed-key two-level forms, the joins of every kind with their capped,
count and chunked forms, compaction, the copy family with ``sample``,
binary and unary ops, casts, Murmur3 hashing, partitioning, the STRING
casts and comparisons, regular expressions, LIST explode)."""

from . import compute, keys, lists, regex
from .binaryop import add, binary_op, div, eq, ge, gt, le, lt, mul, ne, sub
from .cast import cast
from .compaction import distinct, distinct_capped, distinct_count, drop_nulls
from .copying import (
    concatenate, concatenate_columns, copy_if_else, cross_join,
    interleave_columns, repeat, sample, scatter, sequence, slice_rows, split,
)
from .filter import filter_table, filter_table_capped
from .gather import gather_column, gather_table
from .groupby import GroupbyAgg, groupby_aggregate, groupby_aggregate_capped
from .lists import (
    count_elements, explode, explode_outer, explode_position,
    extract_list_element, list_contains,
)
from .regex import (
    contains_re, count_re, extract_re, find_re, matches_re, replace_re, rlike,
)
from .join import (
    anti_join, full_join, inner_join, inner_join_batched, inner_join_batches,
    inner_join_capped, inner_join_count, left_join, left_join_capped,
    left_join_count, membership_mask, right_join, semi_join,
)
from .sort import SortKey, argsort_table, sort_table
from .unaryop import is_nan, is_not_null, is_null, unary_op

__all__ = [
    "compute", "keys", "filter_table", "filter_table_capped",
    "gather_column", "gather_table", "GroupbyAgg", "groupby_aggregate",
    "groupby_aggregate_capped", "inner_join", "inner_join_capped",
    "inner_join_count", "inner_join_batched", "inner_join_batches",
    "left_join", "left_join_capped", "left_join_count", "right_join",
    "full_join", "semi_join", "anti_join", "membership_mask", "distinct",
    "distinct_capped", "distinct_count", "drop_nulls", "concatenate",
    "concatenate_columns", "interleave_columns", "copy_if_else",
    "sequence", "cross_join", "scatter", "slice_rows", "split", "repeat",
    "sample", "SortKey", "argsort_table", "sort_table", "binary_op", "add",
    "sub", "mul", "div", "eq", "ne", "lt", "le", "gt", "ge", "unary_op",
    "is_null", "is_not_null", "is_nan", "cast", "lists", "regex",
    "count_elements", "explode", "explode_outer", "explode_position",
    "extract_list_element", "list_contains", "contains_re", "count_re",
    "extract_re", "find_re", "matches_re", "replace_re", "rlike",
]
