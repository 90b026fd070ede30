"""Ranks and replicas: the (data, model) mesh of ``torch.distributed``
ranks for training, and device replicas for decode (counterparts of
``mint_tpu/parallel``)."""

from mint_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    attention_heads,
    head_split,
    make_mesh,
    param_spec,
    shard_state_dict,
    unshard_state_dict,
)
