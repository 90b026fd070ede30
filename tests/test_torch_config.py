"""The port's own config copy (mint_tpu_torch/config) against the JAX
package's: the same text config, with or without an override merged on
top, gives the same dataclass tree."""

import dataclasses
import os

import pytest

from mint_tpu.config import schema as jax_schema
from mint_tpu_torch.config import schema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "fact_v5_deeper_t10_cm12.config")


@pytest.mark.parametrize("override", [
    None,
    "train_config { batch_size: 8 }",
    # a oneof switch: the LR schedule's siblings are cleared
    "train_config { learning_rate { cosine_decay_learning_rate {"
    " total_steps: 100 } } }",
    # a scalar deep in the model tree
    "multi_modal_model { fact_model { cross_modal_model { transformer {"
    " num_hidden_layers: 3 } } } }",
    # a repeated message field appends
    "multi_modal_model { fact_model { modality { feature_name: \"extra\""
    " sequence_length: 4 } } }",
], ids=["none", "batch_size", "oneof", "model_scalar", "repeated"])
def test_port_config_matches_jax(override):
    ours = schema.load_pipeline_config(CONFIG, config_override=override)
    theirs = jax_schema.load_pipeline_config(CONFIG,
                                             config_override=override)
    assert type(ours).__module__ == "mint_tpu_torch.config.schema"
    tree = dataclasses.asdict(ours)
    # The port's own oneof member (EDGE), which a FACT config leaves unset.
    assert tree["multi_modal_model"].pop("edge_model") is None
    assert tree == dataclasses.asdict(theirs)
    assert (ours.multi_modal_model.which()
            == theirs.multi_modal_model.which() == "fact_model")


@pytest.mark.parametrize("override", [
    None,
    "train_config { batch_size: 8 use_bfloat16: true }",
    "train_config { learning_rate { cosine_decay_learning_rate {"
    " total_steps: 100 } } }",
], ids=["none", "train_scalars", "oneof"])
def test_config_snapshot_text_matches_jax(override, tmp_path):
    """The train CLI's snapshot (the port's copy of serialize.py) writes
    the JAX package's text, and loading it gives the config back."""
    from mint_tpu.config import serialize as jax_serialize
    from mint_tpu_torch.config import serialize

    ours = schema.load_pipeline_config(CONFIG, config_override=override)
    theirs = jax_schema.load_pipeline_config(CONFIG,
                                             config_override=override)
    text = serialize.pipeline_to_text(ours)
    assert text == jax_serialize.pipeline_to_text(theirs)
    path = serialize.save_pipeline_config(ours, str(tmp_path / "run"))
    assert path == str(tmp_path / "run" / "pipeline.config")
    assert schema.load_pipeline_config(path) == ours
