"""The paper's experiment models, the decoder families (``layers``,
``attention``, ``moe``, ``ssm``, ``rglru``, ``transformer``) and the weight carrier to/from the
reference's parameter trees."""
from repro_torch.models import (  # noqa: F401
    attention, convert, layers, moe, paper_models, rglru, sharding, ssm, transformer)
from repro_torch.models.transformer import (  # noqa: F401
    count_active_params,
    count_params,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    param_shapes,
    prefill,
)
