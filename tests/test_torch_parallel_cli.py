"""The port's train CLI as 2 ranks on the CPU (``--distributed``, gloo, the
tiny config of tests/test_torch_train.py): each rank a process with its
own timeout, over a data axis of 2 or a model axis of 2; the run trains,
rank 0 alone writes the metrics and the whole (unsharded) checkpoints,
and a second run resumes from them."""

import os
import sys

import numpy as np
import pytest
import torch

from mint_tpu_torch.config.serialize import pipeline_to_text
from mint_tpu_torch.models import builder
from mint_tpu_torch.parallel.dryrun import free_port, run_ranks
from test_torch_train import _rows, tiny_pipeline_config, write_corpus

TIMEOUT = 180  # seconds a rank may take


def _run(cfg_path, model_dir, steps, axis):
    port = free_port()
    return run_ranks(lambda rank: [
        sys.executable, "-m", "mint_tpu_torch.tools.train",
        f"--config_path={cfg_path}", f"--model_dir={model_dir}",
        f"--steps={steps}", "--device=cpu", "--steps_per_loop=2",
        "--checkpoint_interval=2", "--summary_interval=1",
        "--grad_clip_norm=1.0", "--distributed",
        f"--coordinator_address=127.0.0.1:{port}", "--num_processes=2",
        f"--process_id={rank}", f"--{axis}=2"], 2, TIMEOUT,
        env=dict(os.environ, OMP_NUM_THREADS="2"))


@pytest.mark.parametrize("axis", ["data_parallelism", "tensor_parallelism"])
def test_two_rank_train_cli_trains_checkpoints_and_resumes(tmp_path, axis):
    write_corpus(str(tmp_path / "data"))
    pipeline = tiny_pipeline_config(str(tmp_path / "data" /
                                        "*_tfrecord-train*"))
    cfg_path = tmp_path / "tiny.config"
    cfg_path.write_text(pipeline_to_text(pipeline))
    model_dir = str(tmp_path / "run")

    outs = _run(cfg_path, model_dir, 4, axis)
    shape = "'data': 2, 'model': 1" if axis == "data_parallelism" \
        else "'data': 1, 'model': 2"
    assert all(shape in out for out in outs), outs[0][-2000:]
    rows = _rows(model_dir)
    assert [r["step"] for r in rows] == [1, 3, 4]  # rank 0's only
    assert all(np.isfinite(r["loss"]) for r in rows)
    steps = sorted(int(d) for d in os.listdir(model_dir) if d.isdigit())
    assert steps == [1, 3, 4]
    whole = builder.build(pipeline.multi_modal_model, is_training=True,
                          device="cpu").state_dict()
    for step in steps:
        saved = torch.load(os.path.join(model_dir, str(step), "params.pt"),
                           weights_only=True)
        rest = torch.load(os.path.join(model_dir, str(step),
                                       "opt_state.pt"), weights_only=True)
        assert rest["step"] == step
        for tree in (saved, rest["opt_state"]["mu"], rest["opt_state"]["nu"]):
            assert {k: v.shape for k, v in tree.items()} == \
                {k: v.shape for k, v in whole.items()}

    _run(cfg_path, model_dir, 7, axis)
    assert [r["step"] for r in _rows(model_dir)] == [1, 3, 4, 6, 7]
    steps = sorted(int(d) for d in os.listdir(model_dir) if d.isdigit())
    assert steps == [1, 3, 4, 6, 7]
