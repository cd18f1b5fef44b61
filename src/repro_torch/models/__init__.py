from .init import DenseParams, ParamDict, params_from_numpy
from .model import (
    CACHE_BATCH_AXIS,
    decode_step,
    embed_inputs,
    init_cache,
    init_params,
    lm_logits,
    prefill,
)

__all__ = [
    "CACHE_BATCH_AXIS",
    "DenseParams",
    "ParamDict",
    "decode_step",
    "embed_inputs",
    "init_cache",
    "init_params",
    "lm_logits",
    "params_from_numpy",
    "prefill",
]
