from .catalogue import DaosCatalogue
from .store import DaosStore

__all__ = ["DaosStore", "DaosCatalogue"]
