"""Arrow IPC (Feather v2 file format) read and write (port of the JAX
package's ``io/ipc.py``): the exchange format between host processes,
e.g. a Spark executor handing batches over out of process.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch.profiler import record_function

from ..column import Table, resolve_device

try:  # pyarrow is optional: required at call time, never at import
    import pyarrow as pa
    import pyarrow.ipc as pa_ipc
except ImportError:  # pragma: no cover
    pa = pa_ipc = None


def _require():
    if pa_ipc is None:  # pragma: no cover
        raise ImportError("pyarrow.ipc not available")


def read_arrow_ipc(
    path,
    columns: Optional[Sequence[str]] = None,
    pad_widths: Optional[dict] = None,
    device: Union[str, torch.device] = "cuda",
) -> Table:
    _require()
    from ..interop import table_from_arrow

    dev = resolve_device(device)
    with record_function("io.ipc.read"):
        with pa_ipc.open_file(path) as reader:
            atbl = reader.read_all()
    if columns is not None:
        atbl = atbl.select(list(columns))
    with record_function("io.ipc.upload"):
        return table_from_arrow(atbl, pad_widths=pad_widths, device=dev)


def write_arrow_ipc(table: Table, path) -> None:
    _require()
    from ..interop import table_to_arrow

    with record_function("io.ipc.write"):
        atbl = table_to_arrow(table)
        with pa_ipc.new_file(path, atbl.schema) as writer:
            writer.write_table(atbl)
