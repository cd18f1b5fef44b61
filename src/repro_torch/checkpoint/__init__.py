from .manager import CheckpointManager
from .serialization import decode_array, encode_array, flatten_tree, unflatten_tree

__all__ = ["CheckpointManager", "decode_array", "encode_array", "flatten_tree", "unflatten_tree"]
