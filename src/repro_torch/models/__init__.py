from .init import ModelParams, ParamDict, abstract_params, logical_axes, params_from_numpy
from .model import (
    AUX_COEF,
    CACHE_BATCH_AXIS,
    decode_step,
    embed_inputs,
    encode,
    forward_hidden,
    init_cache,
    init_params,
    lm_logits,
    prefill,
    train_loss,
)
from .ssm import init_ssm_state

__all__ = [
    "AUX_COEF",
    "CACHE_BATCH_AXIS",
    "ModelParams",
    "ParamDict",
    "abstract_params",
    "decode_step",
    "embed_inputs",
    "encode",
    "forward_hidden",
    "init_cache",
    "init_params",
    "init_ssm_state",
    "lm_logits",
    "logical_axes",
    "params_from_numpy",
    "prefill",
    "train_loss",
]
