from repro_torch.models.transformer import (  # noqa: F401
    decode_step,
    forward,
    init_cache,
    init_params,
    params_from_numpy,
    prefill,
)
