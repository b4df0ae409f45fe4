from .sources import TestGen, BlockGen
from .live import LiveTapView
from .debugcheck import debug_checks, DemodCheckError

__all__ = ["TestGen", "BlockGen", "LiveTapView",
           "debug_checks", "DemodCheckError"]
