"""PyTorch/CUDA port of the columnar backend (``spark_rapids_jni_tpu``).

The JAX package stays the reference; this package mirrors its module
paths and public names over torch tensors, with the TPU kernels of its
path rewritten by hand for NVIDIA Hopper (``csrc/``, built on first CUDA
use). It imports neither ``jax`` nor the JAX package.

Entry points (``runtime_bridge.table_upload_wire``,
``Column.from_numpy``, ``Table.from_pydict``) build on ``device="cuda"``
unless the caller asks for ``"cpu"``; every op follows its inputs'
device.
"""

from . import dtype
from .column import Column, Table
from .dtype import DType, TypeId

__version__ = "0.1.0"

_SUBPACKAGES = ("io", "ops", "parallel", "utils", "interop", "rows",
                "factories", "struct", "tpcds")


def __getattr__(name):
    # subpackages load on first access, as the JAX package's do: an
    # import of the package stays light and free of import cycles
    if name in _SUBPACKAGES:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["dtype", "DType", "TypeId", "Column", "Table", "io",
           "__version__"]
