from .catalogue import PosixCatalogue
from .store import PosixStore
from .stats import PosixStats, POSIX_STATS

__all__ = ["PosixStore", "PosixCatalogue", "PosixStats", "POSIX_STATS"]
