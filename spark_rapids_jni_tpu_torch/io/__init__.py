"""Columnar file IO of the PyTorch port (the JAX package's ``io``).

Host decode (Arrow's readers, Arrow's codecs) feeds uploads to the
device, with two-level predicate pushdown:

1. coarse: row-group/stripe pruning against the file footer's
   statistics on the host (no decode, no upload for a pruned group), and
2. exact: the residual predicate evaluated on the device over the
   uploaded batch with the columnar op library (``ops/filter.py``).

``scan_parquet(..., device_decode=True)`` moves the Parquet page decode
of fixed-width columns onto the device (``parquet_device.py``). Every
reader takes ``device=`` (default ``"cuda"``). pyarrow is optional at
import and required when a reader or writer that needs it is called;
Avro needs only the standard library.
"""

from .predicates import Predicate, and_, or_, col  # noqa: F401
from .parquet import (  # noqa: F401
    read_parquet,
    scan_parquet,
    write_parquet,
    parquet_metadata,
)
from .orc import read_orc, scan_orc, write_orc  # noqa: F401
from .csv import read_csv, scan_csv, write_csv  # noqa: F401
from .ipc import read_arrow_ipc, write_arrow_ipc  # noqa: F401
from .json import read_json, scan_json, write_json  # noqa: F401
from .avro import read_avro, write_avro  # noqa: F401

__all__ = [
    "Predicate",
    "and_",
    "or_",
    "col",
    "read_parquet",
    "scan_parquet",
    "write_parquet",
    "parquet_metadata",
    "read_orc",
    "scan_orc",
    "write_orc",
    "read_csv",
    "scan_csv",
    "write_csv",
    "read_arrow_ipc",
    "write_arrow_ipc",
    "read_json",
    "scan_json",
    "write_json",
    "read_avro",
    "write_avro",
]
