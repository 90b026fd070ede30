"""Typed configuration dataclasses mirroring the reference proto schemas.

The port's own copy of ``mint_tpu/config/schema.py`` (the port imports
nothing of the JAX package); keep the two in step.  One member is the
port's alone: ``MultiModalModelConfig.edge_model`` (:class:`EDGEModelConfig`,
EDGE's diffusion generator), which the JAX package does not run.

Field names, defaults, and oneof semantics follow the reference proto2
definitions (``mint/protos/model.proto``, ``dataset.proto``, ``train.proto``,
``eval.proto``, ``pipeline.proto``) so the shipped text configs — e.g.
``configs/fact_v5_deeper_t10_cm12.config`` — load unchanged.

These are plain frozen-ish dataclasses (mutable for convenience) built from
the :class:`mint_tpu_torch.config.textproto.Msg` tree.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from mint_tpu_torch.config import textproto
from mint_tpu_torch.config.textproto import Msg


# ---------------------------------------------------------------------------
# Model configs (reference: mint/protos/model.proto)
# ---------------------------------------------------------------------------


@dataclass
class TransformerConfig:
    """Reference: model.proto `Transformer` (fields 1-16)."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 512
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    masked_loss_type: str = "nce"
    # Spatial-attention / cls-token knobs exist in the reference proto but are
    # unused by the FACT path; kept for config compatibility.
    add_spatial_attention: bool = False
    sp_hidden_size: int = 768
    sp_num_attention_heads: int = 12
    sp_num_hidden_layers: int = 12
    add_cls_token: bool = False
    weight_decay: float = 0.0


@dataclass
class MLPConfig:
    """Reference: model.proto `MLP`."""

    initializer_range: float = 0.02
    hidden_act: str = "gelu"
    out_dim: int = 0


@dataclass
class Conv2DConfig:
    """Reference: model.proto `Conv2D` (unused by FACT, schema parity)."""

    initializer_range: float = 0.02
    filters: int = 0
    kernel_size: int = 1
    strides: int = 1
    hidden_act: str = "linear"


@dataclass
class ModalityModelConfig:
    """Reference: model.proto `ModalityModel` oneof {transformer, mlp}."""

    transformer: Optional[TransformerConfig] = None
    mlp: Optional[MLPConfig] = None
    conv2d: Optional[Conv2DConfig] = None

    def which(self) -> Optional[str]:
        if self.transformer is not None:
            return "transformer"
        if self.mlp is not None:
            return "mlp"
        if self.conv2d is not None:
            return "conv2d"
        return None


@dataclass
class ModalityConfig:
    """Reference: model.proto `Modality`."""

    feature_name: str = ""
    feature_dim: int = 0
    sequence_length: int = 0
    use_look_ahead_mask: bool = False
    model: List[ModalityModelConfig] = field(default_factory=list)


@dataclass
class CrossModalModelConfig:
    """Reference: model.proto `CrossModalModel`."""

    modality_a: str = ""
    modality_b: str = ""
    transformer: Optional[TransformerConfig] = None
    mlp: Optional[MLPConfig] = None
    cross_modal_concat_dim: str = "SEQUENCE_WISE"
    output_layer: MLPConfig = field(default_factory=MLPConfig)
    preprocess: str = "DEFAULT_NONE"


@dataclass
class FACTModelConfig:
    """Reference: model.proto `FACTModel`."""

    modality: List[ModalityConfig] = field(default_factory=list)
    cross_modal_model: CrossModalModelConfig = field(
        default_factory=CrossModalModelConfig)
    fk_path: str = ""

    def modality_by_name(self, name: str) -> ModalityConfig:
        for m in self.modality:
            if m.feature_name == name:
                return m
        raise KeyError(f"modality {name!r} not in config")


@dataclass
class EDGEModelConfig:
    """EDGE (Tseng, Castellon and Liu, "EDGE: Editable Dance Generation
    From Music", CVPR 2023; github.com/Stanford-TML/EDGE ``EDGE.py``, which
    builds ``DanceDecoder(nfeats=151, seq_len=150, latent_dim=512,
    ff_size=1024, num_layers=8, num_heads=8, cond_feature_dim=4800)``, and
    ``model/diffusion.py``'s sampler): a FiLM-conditioned transformer
    denoiser over `seq_len`-frame chunks of `nfeats` motion channels,
    conditioned on `cond_feature_dim` music features a frame through
    `cond_encoder_layers` encoder layers, sampled by DDIM over
    `sampling_steps` of an `n_timestep` cosine schedule with classifier-free
    guidance `guidance_weight` (``models/edge.py``, ``infer/diffusion.py``).
    Proto2-style zero defaults: a config states every field."""

    latent_dim: int = 0
    ff_size: int = 0
    num_layers: int = 0
    num_heads: int = 0
    cond_encoder_layers: int = 0
    cond_feature_dim: int = 0
    nfeats: int = 0
    seq_len: int = 0
    n_timestep: int = 0
    sampling_steps: int = 0
    eta: float = 0.0
    guidance_weight: float = 0.0
    clip_denoised: bool = False


@dataclass
class MultiModalModelConfig:
    """Reference: model.proto `MultiModalModel` oneof {fact_model}; the
    port adds `edge_model`."""

    fact_model: Optional[FACTModelConfig] = None
    edge_model: Optional[EDGEModelConfig] = None

    def which(self) -> Optional[str]:
        if self.fact_model is not None:
            return "fact_model"
        return "edge_model" if self.edge_model is not None else None


# ---------------------------------------------------------------------------
# Dataset configs (reference: mint/protos/dataset.proto)
# ---------------------------------------------------------------------------


@dataclass
class GeneralModalityConfig:
    feature_name: str = ""
    dimension: int = 0
    sample_rate: int = 0
    resize: int = 0
    crop_size: int = 0


@dataclass
class DataModalityConfig:
    general_modality: Optional[GeneralModalityConfig] = None

    def which(self) -> Optional[str]:
        return "general_modality" if self.general_modality is not None else None


@dataclass
class DatasetConfig:
    name: str = ""
    data_files: str = ""
    window_type: str = "DEFAULT_WINDOW"
    data_target_field: str = ""
    create_bert_masks: bool = False
    bert_mask_type: str = "DEFAULT_MASK"
    # List of preprocessor type names, e.g. ["fact_preprocessor"].
    data_augmentation_options: List[str] = field(default_factory=list)
    sample_window: bool = True
    target_num_categories: int = 0
    modality: List[DataModalityConfig] = field(default_factory=list)
    input_length_sec: float = 0.0
    target_length_sec: float = 0.0
    target_shift_sec: float = 0.0
    length_threshold_sec: float = 0.0


# ---------------------------------------------------------------------------
# Train / eval configs (reference: mint/protos/train.proto, eval.proto)
# ---------------------------------------------------------------------------


@dataclass
class ConstantLearningRate:
    learning_rate: float = 0.002


@dataclass
class ExponentialDecayLearningRate:
    initial_learning_rate: float = 0.002
    decay_steps: int = 4_000_000
    decay_factor: float = 0.95
    staircase: bool = True
    burnin_learning_rate: float = 0.0
    burnin_steps: int = 0
    min_learning_rate: float = 0.0


@dataclass
class ManualStepSchedule:
    step: int = 0
    learning_rate: float = 0.002


@dataclass
class ManualStepLearningRate:
    initial_learning_rate: float = 0.002
    schedule: List[ManualStepSchedule] = field(default_factory=list)
    warmup: bool = False


@dataclass
class CosineDecayLearningRate:
    total_steps: int = 4_000_000
    warmup_steps: int = 10_000


@dataclass
class LearningRateConfig:
    """Oneof {constant, exponential_decay, manual_step, cosine_decay}."""

    constant_learning_rate: Optional[ConstantLearningRate] = None
    exponential_decay_learning_rate: Optional[
        ExponentialDecayLearningRate] = None
    manual_step_learning_rate: Optional[ManualStepLearningRate] = None
    cosine_decay_learning_rate: Optional[CosineDecayLearningRate] = None

    def which(self) -> Optional[str]:
        for name in ("constant_learning_rate",
                     "exponential_decay_learning_rate",
                     "manual_step_learning_rate",
                     "cosine_decay_learning_rate"):
            if getattr(self, name) is not None:
                return name
        return None


@dataclass
class TrainConfig:
    num_steps: int = 10_000
    batch_size: int = 4
    use_bfloat16: bool = False
    learning_rate: LearningRateConfig = field(
        default_factory=LearningRateConfig)
    grad_clip_norm: float = 1.0
    fine_tune_checkpoint: str = ""
    fine_tune_checkpoint_type: str = "DEFAULT"


@dataclass
class MotionGenerationMetrics:
    pck_thresholds: List[float] = field(default_factory=list)
    num_joints: int = 24


@dataclass
class EvalConfig:
    batch_size: int = 4
    motion_generation_metrics: Optional[MotionGenerationMetrics] = None


@dataclass
class PipelineConfig:
    """Reference: pipeline.proto `TrainEvalPipelineConfig`."""

    multi_modal_model: MultiModalModelConfig = field(
        default_factory=MultiModalModelConfig)
    train_config: TrainConfig = field(default_factory=TrainConfig)
    train_dataset: DatasetConfig = field(default_factory=DatasetConfig)
    eval_config: EvalConfig = field(default_factory=EvalConfig)
    eval_dataset: DatasetConfig = field(default_factory=DatasetConfig)


# Configs are fields of Flax modules, which jit treats as static arguments —
# so they must be hashable.  Dataclasses with eq=True set __hash__ to None;
# restore a content-based hash (consistent with __eq__, both derive from the
# field values via repr).  Configs must not be mutated after model build.
def _repr_hash(self) -> int:
    return hash(repr(self))


for _cls in (TransformerConfig, MLPConfig, Conv2DConfig,
             ModalityModelConfig,
             ModalityConfig, CrossModalModelConfig, FACTModelConfig,
             EDGEModelConfig, MultiModalModelConfig, GeneralModalityConfig,
             DataModalityConfig, DatasetConfig, ConstantLearningRate,
             ExponentialDecayLearningRate, ManualStepSchedule,
             ManualStepLearningRate, CosineDecayLearningRate,
             LearningRateConfig, TrainConfig, MotionGenerationMetrics,
             EvalConfig, PipelineConfig):
    _cls.__hash__ = _repr_hash


# ---------------------------------------------------------------------------
# Msg -> dataclass mapping
# ---------------------------------------------------------------------------


def _fill(cls, msg: Optional[Msg]):
    """Generic scalar-field filler for flat dataclasses."""
    obj = cls()
    if msg is None:
        return obj
    names = {f.name for f in dataclasses.fields(cls)}
    for key, value in msg.items():
        if key in names and not isinstance(value, Msg):
            setattr(obj, key, value)
    return obj


def _transformer(msg: Optional[Msg]) -> TransformerConfig:
    return _fill(TransformerConfig, msg)


def _mlp(msg: Optional[Msg]) -> MLPConfig:
    return _fill(MLPConfig, msg)


def _modality_model(msg: Msg) -> ModalityModelConfig:
    out = ModalityModelConfig()
    if "transformer" in msg:
        out.transformer = _transformer(msg.get("transformer"))
    elif "mlp" in msg:
        out.mlp = _mlp(msg.get("mlp"))
    elif "conv2d" in msg:
        out.conv2d = _fill(Conv2DConfig, msg.get("conv2d"))
    return out


def _modality(msg: Msg) -> ModalityConfig:
    out = _fill(ModalityConfig, msg)
    ic = msg.get("input_config")
    if isinstance(ic, Msg):
        out.use_look_ahead_mask = bool(ic.get("use_look_ahead_mask", False))
    out.model = [_modality_model(m) for m in msg.get_all("model")]
    return out


def _cross_modal(msg: Optional[Msg]) -> CrossModalModelConfig:
    out = _fill(CrossModalModelConfig, msg)
    if msg is not None:
        if "transformer" in msg:
            out.transformer = _transformer(msg.get("transformer"))
        if "mlp" in msg:
            out.mlp = _mlp(msg.get("mlp"))
        if "output_layer" in msg:
            out.output_layer = _mlp(msg.get("output_layer"))
    return out


def _fact(msg: Msg) -> FACTModelConfig:
    out = FACTModelConfig()
    out.modality = [_modality(m) for m in msg.get_all("modality")]
    out.cross_modal_model = _cross_modal(msg.get("cross_modal_model"))
    out.fk_path = msg.get("fk_path", "")
    return out


def _multi_modal_model(msg: Optional[Msg]) -> MultiModalModelConfig:
    out = MultiModalModelConfig()
    if msg is not None and "fact_model" in msg:
        out.fact_model = _fact(msg.get("fact_model"))
    elif msg is not None and "edge_model" in msg:
        out.edge_model = _fill(EDGEModelConfig, msg.get("edge_model"))
    return out


def _dataset(msg: Optional[Msg]) -> DatasetConfig:
    out = _fill(DatasetConfig, msg)
    if msg is None:
        return out
    out.modality = []
    for m in msg.get_all("modality"):
        dm = DataModalityConfig()
        if "general_modality" in m:
            dm.general_modality = _fill(GeneralModalityConfig,
                                        m.get("general_modality"))
        out.modality.append(dm)
    out.data_augmentation_options = []
    for da in msg.get_all("data_augmentation_options"):
        # Preprocessor oneof: the set field's name identifies the step.
        for key, _ in da.items():
            out.data_augmentation_options.append(key)
    return out


def _learning_rate(msg: Optional[Msg]) -> LearningRateConfig:
    out = LearningRateConfig()
    if msg is None:
        return out
    if "constant_learning_rate" in msg:
        out.constant_learning_rate = _fill(ConstantLearningRate,
                                           msg.get("constant_learning_rate"))
    if "exponential_decay_learning_rate" in msg:
        out.exponential_decay_learning_rate = _fill(
            ExponentialDecayLearningRate,
            msg.get("exponential_decay_learning_rate"))
    if "manual_step_learning_rate" in msg:
        sub = msg.get("manual_step_learning_rate")
        ms = _fill(ManualStepLearningRate, sub)
        ms.schedule = [_fill(ManualStepSchedule, s)
                       for s in sub.get_all("schedule")]
        out.manual_step_learning_rate = ms
    if "cosine_decay_learning_rate" in msg:
        out.cosine_decay_learning_rate = _fill(
            CosineDecayLearningRate, msg.get("cosine_decay_learning_rate"))
    return out


def _train_config(msg: Optional[Msg]) -> TrainConfig:
    out = _fill(TrainConfig, msg)
    if msg is not None:
        out.learning_rate = _learning_rate(msg.get("learning_rate"))
    return out


def _eval_config(msg: Optional[Msg]) -> EvalConfig:
    out = _fill(EvalConfig, msg)
    if msg is not None:
        em = msg.get("eval_metric")
        if isinstance(em, Msg) and "motion_generation_metrics" in em:
            mm = em.get("motion_generation_metrics")
            metrics = _fill(MotionGenerationMetrics, mm)
            metrics.pck_thresholds = [
                float(v) for v in mm.get_all("pck_thresholds")]
            out.motion_generation_metrics = metrics
    return out


def pipeline_from_msg(msg: Msg) -> PipelineConfig:
    return PipelineConfig(
        multi_modal_model=_multi_modal_model(msg.get("multi_modal_model")),
        train_config=_train_config(msg.get("train_config")),
        train_dataset=_dataset(msg.get("train_dataset")),
        eval_config=_eval_config(msg.get("eval_config")),
        eval_dataset=_dataset(msg.get("eval_dataset")),
    )


def load_pipeline_config(path: str,
                         config_override: Optional[str] = None
                         ) -> PipelineConfig:
    """Load a TrainEvalPipelineConfig text proto file.

    Equivalent of reference ``config_util.get_configs_from_pipeline_file``
    (mint/utils/config_util.py:22-50); `config_override` is an additional
    text-proto string merged on top.
    """
    msg = textproto.parse_file(path)
    if config_override:
        _merge_msg(msg, textproto.parse(config_override), PipelineConfig)
    return pipeline_from_msg(msg)


def _field_info(dc_type, key: str):
    """(known, is_list, child_dataclass) for field `key` of `dc_type`.

    Cardinality comes from the dataclass SCHEMA AT THIS MESSAGE TYPE, so
    a forward-compat key that happens to share a name with a List-typed
    field of some other message is not misclassified as repeated.

    Proto wrapper messages the dataclasses FLATTEN (`eval.proto:24`'s
    singular ``EvalMetric eval_metric``, whose oneof members EvalConfig
    holds directly) are modeled as TRANSPARENT: the walk continues with
    the same dataclass type, so fields reached through the wrapper keep
    their schema-derived cardinality."""
    import dataclasses as dc
    import sys

    if dc_type is None or not dc.is_dataclass(dc_type):
        return False, False, None
    wrapped = _TRANSPARENT_WRAPPERS.get((dc_type, key))
    if wrapped is not None:
        return True, False, wrapped
    for f in dc.fields(dc_type):
        if f.name != key:
            continue
        t = str(f.type).replace("typing.", "")
        is_list = t.startswith("List[")
        inner = t[t.index("[") + 1:t.rindex("]")] if "[" in t else t
        if inner.startswith("Optional["):
            inner = inner[len("Optional["):-1]
        child = getattr(sys.modules[__name__], inner, None)
        child = child if dc.is_dataclass(child) else None
        return True, is_list, child
    return False, False, None


# Proto wrapper messages the dataclasses flatten away, keyed by the
# dataclass whose fields absorb the wrapper's members (see _field_info).
_TRANSPARENT_WRAPPERS = {
    (EvalConfig, "eval_metric"): EvalConfig,
}

# Oneof groups per containing dataclass (reference .proto `oneof`
# blocks).  protobuf semantics: SETTING a oneof member CLEARS its
# siblings — `text_format.Merge` of an override that switches a oneof
# to a different member replaces the base's member, it does not leave
# both set.  Without this, an override switching e.g. the LR schedule
# was silently ignored (`which()` probes members in fixed order and
# found the base's member first).  EvalMetric's members live here under
# EvalConfig because the dataclasses flatten that wrapper
# (_TRANSPARENT_WRAPPERS keeps the merge walk typed through it).
_ONEOF_GROUPS = (
    (LearningRateConfig, ("constant_learning_rate",
                          "exponential_decay_learning_rate",
                          "manual_step_learning_rate",
                          "cosine_decay_learning_rate")),
    (ModalityModelConfig, ("transformer", "mlp", "conv2d")),
    (CrossModalModelConfig, ("transformer", "mlp")),
    (MultiModalModelConfig, ("fact_model", "edge_model")),
    (DataModalityConfig, ("general_modality",)),
    (EvalConfig, ("motion_prediction_metrics",
                  "motion_generation_metrics")),
)
_ONEOF_BY_MEMBER = {(dc, member): members
                    for dc, members in _ONEOF_GROUPS for member in members}


def _merge_msg(base: Msg, override: Msg, dc_type=None) -> None:
    """Recursive merge with protobuf ``text_format.Merge`` semantics:
    singular message fields merge field-by-field, singular scalar fields
    are overwritten, repeated fields (message or scalar) are appended —
    repeated-ness comes from the dataclass schema at the CURRENT message
    type (``_field_info``, which also resolves flattened wrapper keys);
    for fields the dataclasses don't model (forward-compat keys kept
    only in the Msg tree) the occurrence-count heuristic applies — never
    collapse a multi-occurrence field with replace().
    """
    for key, value in override.items():
        # Oneof: before merging a member, clear its SIBLINGS from the
        # base (protobuf Merge replaces the active member; merging the
        # SAME member merges field-by-field as usual).
        group = _ONEOF_BY_MEMBER.get((dc_type, key)) if dc_type else None
        if group is not None:
            for sibling in group:
                if sibling != key and sibling in base:
                    base.remove(sibling)
        existing = base.get(key)
        known, is_list, child_dc = _field_info(dc_type, key)
        repeated = ((is_list if known else False)
                    or len(base.get_all(key)) > 1
                    or len(override.get_all(key)) > 1)
        if isinstance(value, Msg) and isinstance(existing, Msg) \
                and not repeated:
            _merge_msg(existing, value, child_dc)
        elif not isinstance(value, Msg):
            if repeated:
                base.add(key, value)  # repeated scalar: Merge appends
            else:
                base.replace(key, value)
        else:
            base.add(key, value)


def configs_dict(pipeline: PipelineConfig) -> Dict[str, Any]:
    """Reference-parity dict view (config_util returns a dict of 5 configs)."""
    return {
        "model": pipeline.multi_modal_model,
        "train_config": pipeline.train_config,
        "train_dataset": pipeline.train_dataset,
        "eval_config": pipeline.eval_config,
        "eval_dataset": pipeline.eval_dataset,
    }
