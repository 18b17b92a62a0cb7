"""The port's op library: the JAX package's ``ops/`` (keys, gather,
filter, sort, groupby with its capped, chunked and packed-key forms, the
joins of every kind with their capped, count and chunked forms,
compaction, the copy family with ``sample``, binary and unary ops,
casts, Murmur3 hashing, partitioning, the STRING casts and comparisons,
regular expressions, LIST explode, window functions, reductions, scans,
quantiles, search, replace, rounding and datetime).

``WAITING`` names the JAX package's exports the port does not have yet,
each with the ROADMAP Queue 1 item that brings it."""

from . import compute, datetime, keys, lists, regex, replace, rounding, window
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
from .groupby_chunked import (
    groupby_aggregate_capped_chunked, groupby_aggregate_chunked,
)
from .hashing import murmur3_column, murmur3_table
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
from .partition import hash_partition, round_robin_partition
from .quantiles import quantile
from .reductions import arg_extreme, extreme_by
from .reductions import reduce as reduce_column
from .replace import (
    clamp, find_and_replace, nans_to_nulls, replace_nulls,
    replace_nulls_policy,
)
from .rounding import round_column
from .scan import scan
from .search import contains_column, lower_bound, upper_bound
from .sort import SortKey, argsort_table, is_sorted, merge_sorted, sort_table
from .unaryop import is_nan, is_not_null, is_null, unary_op
from .window import (
    dense_rank, grouped_range_rolling_aggregate, grouped_rolling_aggregate,
    lag, lead, ntile, percent_rank, rank, rolling_aggregate, row_number,
)

#: JAX ``ops.__all__`` names still to port -> the ROADMAP Queue 1 item
WAITING = {
    "split_explode": "item 6 (the rest of the strings)",
}

__all__ = [
    "compute", "keys", "filter_table", "filter_table_capped",
    "gather_column", "gather_table", "GroupbyAgg", "groupby_aggregate",
    "groupby_aggregate_capped", "groupby_aggregate_chunked",
    "groupby_aggregate_capped_chunked", "inner_join", "inner_join_capped",
    "inner_join_count", "inner_join_batched", "inner_join_batches",
    "left_join", "left_join_capped", "left_join_count", "right_join",
    "full_join", "semi_join", "anti_join", "membership_mask", "distinct",
    "distinct_capped", "distinct_count", "drop_nulls", "concatenate",
    "concatenate_columns", "interleave_columns", "copy_if_else",
    "sequence", "cross_join", "scatter", "slice_rows", "split", "repeat",
    "sample", "SortKey", "argsort_table", "sort_table", "is_sorted",
    "merge_sorted", "binary_op", "add", "sub", "mul", "div", "eq", "ne",
    "lt", "le", "gt", "ge", "unary_op", "is_null", "is_not_null", "is_nan",
    "cast", "lists", "regex", "count_elements", "explode", "explode_outer",
    "explode_position", "extract_list_element", "list_contains",
    "contains_re", "count_re", "extract_re", "find_re", "matches_re",
    "replace_re", "rlike", "murmur3_column", "murmur3_table",
    "hash_partition", "round_robin_partition", "reduce_column",
    "arg_extreme", "extreme_by", "round_column", "datetime", "replace",
    "rounding", "replace_nulls", "replace_nulls_policy", "nans_to_nulls",
    "find_and_replace", "clamp", "lower_bound", "upper_bound",
    "contains_column", "scan", "window", "rolling_aggregate",
    "grouped_rolling_aggregate", "grouped_range_rolling_aggregate", "lead",
    "lag", "row_number", "rank", "dense_rank", "percent_rank", "ntile",
    "quantile",
]
