"""The TPC-DS query tier (port of the JAX repository's ``benchmarks/``
query half): the seeded star schema (``datagen``), q5/q23/q64 as op
DAGs on one device and over a mesh (``queries``), and the Parquet star
schema with its streamed queries and pandas oracles (``streams``).

Functions here return Tables and DataFrames: no timer, no configuration
list and no result line. The JAX runner (``benchmarks/run.py``,
``tpcds.run_all``, ``tpcds.run_distributed``) has no counterpart here.
"""

from . import datagen, queries, streams

__all__ = ["datagen", "queries", "streams"]
