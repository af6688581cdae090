"""serve substrate (port of ``repro/serve``)."""
from .engine import Engine
from .paging import NULL_BLOCK, BlockAllocator, OutOfBlocksError
from .scheduler import ServeScheduler

__all__ = ["Engine", "ServeScheduler", "BlockAllocator", "OutOfBlocksError",
           "NULL_BLOCK"]
