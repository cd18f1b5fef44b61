from .init import ModelParams, ParamDict, params_from_numpy
from .model import (
    AUX_COEF,
    CACHE_BATCH_AXIS,
    decode_step,
    embed_inputs,
    forward_hidden,
    init_cache,
    init_params,
    lm_logits,
    prefill,
    train_loss,
)

__all__ = [
    "AUX_COEF",
    "CACHE_BATCH_AXIS",
    "ModelParams",
    "ParamDict",
    "decode_step",
    "embed_inputs",
    "forward_hidden",
    "init_cache",
    "init_params",
    "lm_logits",
    "params_from_numpy",
    "prefill",
    "train_loss",
]
