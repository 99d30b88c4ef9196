"""repro_torch.core — the task runtime + Task-Aware Collectives on PyTorch.

The port's counterpart of ``repro.core``: the two generic runtime APIs
proposed by the paper (§4) with their original names, the task runtime
that implements them, the TAC library (the TAMPI analogue, with CUDA events
as the device completion test), the schedule IR with its host executor
(Level A), and its Level-B executor on logical ranks (``mesh``,
``lowering``, ``overlap``, ``pipeline``), the ULFM resilience helpers
(``resilience``) and the deterministic makespan simulator (``simulate``)
that replays the benchmarks' task graphs for their scaling curves.
"""

from .events import (BlockingContext, EventCounter,
                     get_current_blocking_context, block_current_task,
                     unblock_task, get_current_event_counter,
                     increase_current_task_event_counter,
                     decrease_task_event_counter, current_task)
from .polling import PollingRegistry
from . import continuations
from .continuations import Continuation, ContinuationEngine
from .taskgraph import Task, TaskGraph
from .executor import TaskRuntime, TaskError
from . import tac
from . import schedule
from . import collectives
from . import options
from . import mesh, lowering, overlap, pipeline
from . import resilience
from . import simulate
from .resilience import FaultInjector
from .schedule import Schedule, build_neighbor, best_schedule
from .collectives import (Collectives, CollectiveHandle, HaloExchange,
                          HierarchicalCollectives, PersistentCollective)
from .options import CollectiveOptions
from .tac import (CommWorld, CommGroup, CartGroup, DistGraphGroup,
                  RankFailedError, CommRevokedError, AsyncHandle,
                  ArrayHandle, as_handle)

__all__ = [
    # pause/resume API (§4.1)
    "get_current_blocking_context", "block_current_task", "unblock_task",
    # external events API (§4.3)
    "get_current_event_counter", "increase_current_task_event_counter",
    "decrease_task_event_counter",
    # polling services API (§4.2) — register/unregister live on the registry
    "PollingRegistry",
    # continuation-based completion notification (poll-free progress)
    "continuations", "Continuation", "ContinuationEngine",
    # runtime
    "Task", "TaskGraph", "TaskRuntime", "TaskError", "BlockingContext",
    "EventCounter", "current_task",
    # TAMPI analogue + task-aware collectives
    "tac", "collectives", "Collectives", "CollectiveHandle",
    # unified async-handle protocol + consolidated tuning spec
    "AsyncHandle", "ArrayHandle", "as_handle", "options",
    "CollectiveOptions",
    # schedule IR + its host executor
    "schedule", "Schedule", "build_neighbor", "best_schedule",
    # sub-communicators + neighbourhood collectives
    "CommWorld", "CommGroup", "CartGroup", "DistGraphGroup", "HaloExchange",
    "HierarchicalCollectives",
    # persistent collectives (MPI_*_init analogue)
    "PersistentCollective",
    # ULFM failure model (revoke/shrink live on CommWorld) + injection
    "RankFailedError", "CommRevokedError", "resilience", "FaultInjector",
    # Level-B executor on logical ranks
    "mesh", "lowering", "overlap", "pipeline",
    # deterministic makespan simulator (the scaling curves)
    "simulate",
]
