from .tp import (
    shard_dense_params, quantize_linear_tp, quantize_params_tp, quantize_tp,
    place_params_tp,
    make_tp_forward,
)
