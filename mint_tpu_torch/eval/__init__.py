"""Offline evaluation: the batched generation evaluator, motion features,
FID scoring and beat alignment (counterparts of ``mint_tpu/eval``)."""

from mint_tpu_torch.eval.features import (  # noqa: F401
    extract_kinetic_features,
    extract_manual_features,
)
from mint_tpu_torch.eval.fid import (  # noqa: F401
    frechet_distance,
    normalize_by_reference,
)
