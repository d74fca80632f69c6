from .engine import ServingEngine, EngineConfig, merge_topk
from .runtime import RuntimeConfig, RuntimeStats, ServingRuntime, Ticket

__all__ = ["ServingEngine", "EngineConfig", "merge_topk", "RuntimeConfig",
           "RuntimeStats", "ServingRuntime", "Ticket"]
