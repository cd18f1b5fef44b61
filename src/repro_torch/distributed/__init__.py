from .sharding import constrain

__all__ = ["constrain"]
