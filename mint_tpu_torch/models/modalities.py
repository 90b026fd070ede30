"""Modality config expansion (copy of ``mint_tpu/models/modalities.py``:
the port imports nothing of the JAX package).

Turns the repeated `Modality` configs into three lookups:
``feature_to_model`` (per-feature model pieces), ``feature_to_params``
(sequence_length / feature_dim) and ``feature_to_preprocessor`` (None:
the reference's preprocessing layer is a stub).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from mint_tpu_torch.config.schema import ModalityConfig


def build_modalities_model(modality_configs: List[ModalityConfig]
                           ) -> Tuple[Dict, Dict, Dict]:
    feature_to_model: Dict[str, Dict] = {}
    feature_to_params: Dict[str, Dict] = {}
    feature_to_preprocessor: Dict[str, None] = {}
    for modality in modality_configs:
        name = modality.feature_name
        feature_to_params[name] = {
            "sequence_length": modality.sequence_length,
            "feature_dim": modality.feature_dim,
        }
        feature_to_preprocessor[name] = None  # stubbed in the reference
        models: Dict[str, object] = {}
        for model in modality.model:
            which = model.which()
            if which == "transformer":
                models["transformer_layer"] = model.transformer
            elif which == "mlp":
                models["mlp_layer"] = model.mlp
        feature_to_model[name] = models
    return feature_to_model, feature_to_params, feature_to_preprocessor
