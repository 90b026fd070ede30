"""Config -> textproto serialization (inverse of the loader): the port's
copy of ``mint_tpu/config/serialize.py``.

Equivalent of the reference's ``create_pipeline_proto_from_configs`` +
``save_pipeline_config`` (mint/utils/config_util.py:53-89): the trainer
snapshots the effective config as ``{model_dir}/pipeline.config`` so runs
are reproducible from the model dir alone.

Emits only fields that differ from the dataclass defaults, plus the
structural wrappers the reference schema nests them in
(``data_augmentation_options { fact_preprocessor {} }``,
``input_config { use_look_ahead_mask }``, ``eval_metric { ... }``).
Round-trip: ``load_pipeline_config(save(...)) == original``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List

from mint_tpu_torch.config import schema as S


# String-typed dataclass fields that are ENUMS in the reference protos
# (dataset.proto BERTMaskType/WindowType, model.proto CrossModalConcatDim/
# Preprocess, train.proto CheckpointType).  Only these may serialize
# unquoted: protobuf text_format rejects quoted enum identifiers AND
# rejects unquoted values for genuine string fields — an ALL_CAPS
# heuristic would emit `name: AIST` for a string field named "AIST",
# which the reference's config_util could not parse back.
_ENUM_FIELDS = {
    (S.DatasetConfig, "window_type"),
    (S.DatasetConfig, "bert_mask_type"),
    (S.CrossModalModelConfig, "cross_modal_concat_dim"),
    (S.CrossModalModelConfig, "preprocess"),
    (S.TrainConfig, "fine_tune_checkpoint_type"),
}


def _fmt_scalar(value: Any, enum: bool = False) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, str):
        if enum:
            return value  # bare identifier; quoted enums are rejected
        return '"%s"' % value.replace("\\", "\\\\").replace('"', '\\"')
    if isinstance(value, float):
        return repr(value)
    return str(value)


def _emit_dataclass(obj, name: str, lines: List[str], indent: int) -> None:
    pad = "  " * indent
    body: List[str] = []
    _emit_fields(obj, body, indent + 1)
    if body:
        lines.append(f"{pad}{name} {{")
        lines.extend(body)
        lines.append(f"{pad}}}")
    else:
        lines.append(f"{pad}{name} {{")
        lines.append(f"{pad}}}")


def _emit_fields(obj, lines: List[str], indent: int) -> None:
    pad = "  " * indent
    defaults = type(obj)()
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if value is None:
            continue

        # Structural special cases mirroring the proto schema nesting.
        if isinstance(obj, S.ModalityConfig) and f.name == "use_look_ahead_mask":
            if value:
                lines.append(f"{pad}input_config {{")
                lines.append(f"{pad}  use_look_ahead_mask: true")
                lines.append(f"{pad}}}")
            continue
        if isinstance(obj, S.DatasetConfig) and \
                f.name == "data_augmentation_options":
            for step in value:
                lines.append(f"{pad}data_augmentation_options {{")
                lines.append(f"{pad}  {step} {{")
                lines.append(f"{pad}  }}")
                lines.append(f"{pad}}}")
            continue
        if isinstance(obj, S.EvalConfig) and \
                f.name == "motion_generation_metrics":
            lines.append(f"{pad}eval_metric {{")
            _emit_dataclass(value, "motion_generation_metrics", lines,
                            indent + 1)
            lines.append(f"{pad}}}")
            continue

        if dataclasses.is_dataclass(value):
            # Skip all-default singular messages that are also default
            # in a fresh instance (avoid noise), except oneof members
            # (those are None by default, handled by the None check).
            default = getattr(defaults, f.name, None)
            if default is not None and value == default:
                continue
            _emit_dataclass(value, f.name, lines, indent)
        elif isinstance(value, list):
            for item in value:
                if dataclasses.is_dataclass(item):
                    _emit_dataclass(item, f.name, lines, indent)
                else:
                    lines.append(f"{pad}{f.name}: {_fmt_scalar(item)}")
        else:
            if value == getattr(defaults, f.name, None):
                continue
            enum = (type(obj), f.name) in _ENUM_FIELDS
            lines.append(f"{pad}{f.name}: {_fmt_scalar(value, enum=enum)}")


def pipeline_to_text(pipeline: S.PipelineConfig) -> str:
    """Serialize a PipelineConfig to reference-compatible textproto."""
    lines: List[str] = []
    _emit_dataclass(pipeline.multi_modal_model, "multi_modal_model", lines,
                    0)
    _emit_dataclass(pipeline.train_dataset, "train_dataset", lines, 0)
    _emit_dataclass(pipeline.eval_dataset, "eval_dataset", lines, 0)
    _emit_dataclass(pipeline.train_config, "train_config", lines, 0)
    _emit_dataclass(pipeline.eval_config, "eval_config", lines, 0)
    return "\n".join(lines) + "\n"


def save_pipeline_config(pipeline: S.PipelineConfig,
                         directory: str) -> str:
    """Write ``{directory}/pipeline.config``
    (reference config_util.py:75-89); returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "pipeline.config")
    with open(path, "w") as f:
        f.write(pipeline_to_text(pipeline))
    return path
