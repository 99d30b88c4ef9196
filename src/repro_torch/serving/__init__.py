"""repro_torch.serving — continuous-batching LM serving on the port's task
runtime (the port of ``repro.serving``).

Every prefill, decode micro-step and host detokenisation is a
:class:`repro_torch.core.executor.TaskRuntime` task, bound to device
completion through the :class:`repro_torch.core.tac.AsyncHandle` protocol
(a CUDA event on the card).  :class:`~repro_torch.serving.lm.LMAdapter`
serves the real model; :class:`SyntheticAdapter` is the deterministic
stand-in the engine's tests use.
"""

from ..obs.metrics import MetricSink, TokenRecord, percentile
from .engine import ServingEngine
from .metrics import ServeReport
from .queue import RequestQueue
from .request import Request, RequestState
from .synthetic import SyntheticAdapter, token_at

__all__ = [
    "ServingEngine", "Request", "RequestState", "RequestQueue",
    "ServeReport", "TokenRecord", "MetricSink", "percentile",
    "SyntheticAdapter", "token_at",
]
