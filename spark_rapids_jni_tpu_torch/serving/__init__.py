"""Multi-tenant serving tier: the resident-daemon deployment (port of
``serving/``).

One long-lived device process serves many concurrent Spark tasks: a
localhost query-stream daemon (:class:`~.server.Server`, on the device
it is given) with per-client sessions (:class:`~.session.Session`:
scoped table namespace + device memory budget), weighted-deficit
fair-share scheduling with typed BUSY shedding
(:class:`~.scheduler.FairScheduler`), durable checkpoints with resume
after a crash (``durable.py``), and a client (:class:`~.client.Client`)
that speaks to either package's daemon.
"""

from .client import (  # noqa: F401
    Client,
    ServingBusy,
    ServingCancelled,
    ServingCheckpointCorrupt,
    ServingDeadlineExceeded,
    ServingDegraded,
    ServingDraining,
    ServingError,
    ServingOverBudget,
    ServingQuarantined,
    ServingResourceExhausted,
    ServingResumeDenied,
    ServingSessionLimit,
    ServingTableError,
    ServingTransientError,
)
from .durable import (  # noqa: F401
    CheckpointCorrupt,
    Draining,
    ResumeDenied,
    SessionQuarantined,
)
from .scheduler import Busy, FairScheduler, Ticket  # noqa: F401
from .server import Server, SessionLimit, serve  # noqa: F401
from .session import (  # noqa: F401
    OverBudget,
    Session,
    SessionClosed,
    estimate_request_bytes,
)

__all__ = [
    "Busy",
    "CheckpointCorrupt",
    "Client",
    "Draining",
    "FairScheduler",
    "OverBudget",
    "ResumeDenied",
    "Server",
    "ServingBusy",
    "ServingCancelled",
    "ServingCheckpointCorrupt",
    "ServingDeadlineExceeded",
    "ServingDegraded",
    "ServingDraining",
    "ServingError",
    "ServingOverBudget",
    "ServingQuarantined",
    "ServingResourceExhausted",
    "ServingResumeDenied",
    "ServingSessionLimit",
    "ServingTableError",
    "ServingTransientError",
    "Session",
    "SessionClosed",
    "SessionLimit",
    "SessionQuarantined",
    "Ticket",
    "estimate_request_bytes",
    "serve",
]
