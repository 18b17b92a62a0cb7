"""``python -m spark_rapids_jni_tpu_torch.kernels``: see :func:`main`."""

import sys

from . import main

sys.exit(main())
