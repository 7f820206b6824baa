"""repro_torch.serving -- inference half of the port (dense and MoE models).

Counterpart of ``repro/serving``. ``serve_step``: single-batch prefill +
decode loop (the correctness baseline). ``engine``: the continuous-batching
serving engine with admission control, deadlines, and graceful degradation.
``kvcache``: block-granular paged KV pool shared by the engine.
"""

from repro_torch.serving.engine import (  # noqa: F401
    EngineConfig,
    Request,
    ServingEngine,
    SERVE_EVENTS,
)
from repro_torch.serving.kvcache import BlockPool, KVCacheError, PagedKVCache  # noqa: F401
from repro_torch.serving.serve_step import generate, serve_step  # noqa: F401
