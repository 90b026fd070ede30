"""The port over ranks and replicas (``mint_tpu_torch/parallel``, the
mesh paths of the model, trainer, checkpoint, device dataset and the
decode's replicas) against the JAX package on the CPU.

The JAX package's numbers do not depend on how it is sharded, so each
oracle is the JAX function on the matching mesh of conftest.py's 8
virtual CPU devices.  Multi-rank runs start one gloo rank a process
(``tests/torch_parallel_worker.py``, which imports no JAX), each with a
timeout: a hang fails instead of eating the run's clock.  Tolerances:
f32 forwards within 1e-5 of the output's peak; a train step's loss within
1e-5 relative, every parameter and Adam moment within 1e-5 of its leaf's
peak (the two sides sum in different orders; a sharded sum adds its
partials in yet another).
"""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__
from mint_tpu.eval.evaluator import Evaluator as JaxEvaluator
from mint_tpu.models.fact import FACT as JaxFACT
from mint_tpu.models.fact import init_params as jax_init_params
from mint_tpu.parallel import make_mesh
from mint_tpu.parallel import mesh as jax_mesh
from mint_tpu.train import Trainer as JaxTrainer
from mint_tpu.train import schedules as jax_schedules
from mint_tpu_torch.config import schema as S
from mint_tpu_torch.data.device_dataset import DeviceDataset
from mint_tpu_torch.eval.evaluator import Evaluator
from mint_tpu_torch.infer import decoder
from mint_tpu_torch.models import builder, weights
from mint_tpu_torch.models.fact import FACT, init_params
from mint_tpu_torch.parallel import mesh as mesh_lib
from mint_tpu_torch.parallel.dryrun import (dryrun, free_port, run_ranks,
                                            tiny_fact_config)
from mint_tpu_torch.parallel.replicas import Replicas, devices_for
from mint_tpu_torch.serving.server import GenerationService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
CONFIG = os.path.join(REPO, "configs", "fact_v5_deeper_t10_cm12.config")
TIMEOUT = 180  # seconds a rank may take


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    """Rank processes of 2 threads each: the suite runs beside other
    workers, and a rank's tiny model gains nothing from more."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


def _jax_pair(seed=0):
    """(JAX model, its params as numpy, the port's whole f32 model with
    the same weights) on the JAX entry's tiny config: width 32, 4 heads,
    2 blocks, MLP 64."""
    jax_model = JaxFACT(__graft_entry__._tiny_fact_config())
    params = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax_model, jax.random.PRNGKey(seed)))
    model = FACT(tiny_fact_config())
    model.load_state_dict(weights.from_jax_params(params, model))
    return jax_model, params, model


def _run_ranks(task, world, work):
    """Run `task` on `world` gloo ranks, one process each (see
    run_ranks: a failure or a timeout raises)."""
    port = free_port()
    run_ranks(lambda r: [sys.executable, WORKER, task, str(r), str(world),
                         str(port), str(work)], world, TIMEOUT)


# -- the partition rules -------------------------------------------------------

def test_param_spec_equals_jax_on_every_leaf():
    """Every leaf's spec is the JAX rule's, by its Flax path; the torch
    dim split is that spec read in nn.Linear's [out, in] layout."""
    _, params, model = _jax_pair()
    for key, (path, transpose) in weights._leaf_names(model).items():
        want = tuple(jax_mesh.param_spec(path))
        assert mesh_lib.param_spec(path) == want, path
        dim = mesh_lib.shard_dim(key)
        if "model" not in want:
            assert dim is None, key
        else:
            torch_spec = want[::-1] if transpose else want
            assert dim == torch_spec.index("model"), key


@pytest.mark.parametrize("model_ax", [2, 4])
def test_shard_unshard_round_trip_and_head_split(model_ax):
    """The slices round-trip bit for bit; each split leaf is cut along its
    spec's dim to 1 / model, the rest copied whole; and to_qkv's slice is
    the rank's heads of q, k and v, which at 4 heads differ from the
    contiguous column block JAX's spec names (GSPMD reshards behind
    it)."""
    _, _, model = _jax_pair()
    full = model.state_dict()
    heads = mesh_lib.attention_heads(model)
    shards = [mesh_lib.shard_state_dict(full, mesh_lib.Mesh(1, model_ax, r),
                                        heads)
              for r in range(model_ax)]
    back = mesh_lib.unshard_state_dict(shards)
    assert list(back) == list(full)
    for key in full:
        assert torch.equal(back[key], full[key]), key
        dim = mesh_lib.shard_dim(key)
        for shard in shards:
            want = list(full[key].shape)
            if dim is not None:
                want[dim] //= model_ax
            assert list(shard[key].shape) == want, key
    key = "cross_modal_layer.transformer.block_0.attn.to_qkv.weight"
    dim, heads = 32, 4
    hd = dim // heads
    per = heads // model_ax
    for r, shard in enumerate(shards):
        rows = [s * dim + (r * per + h) * hd + j for s in range(3)
                for h in range(per) for j in range(hd)]
        assert torch.equal(shard[key], full[key][rows])
        contiguous = full[key].chunk(model_ax, dim=0)[r]
        assert not torch.equal(shard[key], contiguous)


def test_build_refuses_heads_that_do_not_split():
    """The flagship's 10 heads split over 2, 4, 8 and 16 model ranks, the
    sizes that divide the dims the JAX rules split, 800, 2400 and 3072
    (uneven heads: 3, 3, 2, 2 at 4; at 16, more ranks than heads, each
    head over a group of 2 or 1 ranks), as JAX takes them; a model axis
    that does not divide a split dim is refused, naming the field."""
    from mint_tpu_torch.config.schema import load_pipeline_config

    cfg = load_pipeline_config(CONFIG).multi_modal_model.fact_model
    for model in (2, 4, 8, 16):
        builder.check_split(cfg, model)
    builder.check_kernel_limits(cfg, torch.bfloat16, 2)  # F = 1536 fits
    builder.check_kernel_limits(cfg, torch.bfloat16, 4)  # F = 768 fits
    builder.check_kernel_limits(cfg, torch.float32, 8)
    builder.check_kernel_limits(cfg, torch.float32, 16)
    with pytest.raises(ValueError, match="hidden_size 800 does not split "
                       "over 3 model ranks"):
        builder.check_split(cfg, 3)
    with pytest.raises(ValueError, match="intermediate_size 3072 does not "
                       "split over 5 model ranks"):
        builder.check_split(cfg, 5)
    assert [mesh_lib.head_split(10, 4, r) for r in range(4)] == [
        (0, 3), (3, 3), (6, 2), (8, 2)]
    assert [mesh_lib.head_split(6, 4, r) for r in range(4)] == [
        (0, 2), (2, 2), (4, 1), (5, 1)]
    assert [mesh_lib.head_split(10, 2, r) for r in range(2)] == [
        (0, 5), (5, 5)]
    # 16 ranks over 10 heads of 80: groups of 2, 2, 2, 2, 2, 2, 1, 1, 1, 1,
    # a rank of a pair holding 40 of its head's columns.
    assert [mesh_lib.head_group(10, 16, r)[2] for r in range(16)] == [
        2] * 12 + [1] * 4
    assert [mesh_lib.head_columns(10, 80, 16, r) for r in (0, 1, 2, 12, 15)
            ] == [(0, 40), (40, 80), (80, 120), (480, 560), (720, 800)]


# A model axis wider than the heads: 2 heads of 24 at width 48 and MLP 64,
# over 4 model ranks (groups of 2 a head, 12 of its columns a rank).
WIDE_AXIS = {"hidden_size": 48, "heads": 2, "intermediate_size": 64}


def test_model_axis_wider_than_heads_shards_bit_for_bit():
    """Over 4 ranks each of the 2 heads takes a group of 2: a rank's model
    holds 12 of its head's 24 columns of q, k and v (to_qkv's rows) and the
    same rows of to_out's input, the MLP's even quarter; the slices load
    into those models and round-trip bit for bit."""
    cfg = S.MultiModalModelConfig(fact_model=tiny_fact_config(**WIDE_AXIS))
    whole = builder.build(cfg, is_training=False, device="cpu")
    gen = torch.Generator().manual_seed(6)
    full = {k: torch.randn(v.shape, generator=gen)
            for k, v in whole.state_dict().items()}
    heads = mesh_lib.attention_heads(whole)
    shards = []
    for r in range(4):
        mesh = mesh_lib.Mesh(1, 4, r)
        shard = mesh_lib.shard_state_dict(full, mesh, heads)
        rank_model = builder.build(cfg, is_training=False, device="cpu",
                                   mesh=mesh)
        rank_model.load_state_dict(shard)
        attn = rank_model.cross_modal_layer.transformer.block_0.attn
        assert (attn.head_start, attn.heads) == (r // 2, 1)
        assert attn.columns == (12 * (r % 2), 12)
        prefix = "cross_modal_layer.transformer.block_0.attn."
        cols = [24 * (r // 2) + 12 * (r % 2) + j for j in range(12)]
        rows = [s * 48 + c for s in range(3) for c in cols]
        assert torch.equal(shard[prefix + "to_qkv.weight"],
                           full[prefix + "to_qkv.weight"][rows])
        assert torch.equal(shard[prefix + "to_out.weight"],
                           full[prefix + "to_out.weight"][:, cols])
        shards.append(shard)
    back = mesh_lib.unshard_state_dict(shards)
    assert list(back) == list(full)
    for key in full:
        assert torch.equal(back[key], full[key]), key


@pytest.mark.parametrize("heads", [2, 3])
def test_model_axis_wider_than_heads_over_4_ranks_matches_one_rank(
        tmp_path, heads):
    """4 gloo ranks over 2 heads (groups of 2, each rank 12 of its head's
    24 columns, the head gathered before attention), or over 3 (groups of
    2, 1 and 1: two ranks hold a whole head alone), give the single-rank
    port's f32 loss within 1e-5 relative and every gradient, gathered
    whole, within 1e-5 of its leaf's peak."""
    from mint_tpu_torch.train import Trainer, schedules

    widths = dict(WIDE_AXIS, heads=heads)
    model = FACT(tiny_fact_config(**widths))
    init_params(model, torch.Generator().manual_seed(7))
    rng = np.random.default_rng(10)
    batch = {"motion_input": rng.standard_normal((3, 8, 9), np.float32),
             "audio_input": rng.standard_normal((3, 16, 35), np.float32),
             "target": rng.standard_normal((3, 4, 9), np.float32)}
    torch.save(model.state_dict(), tmp_path / "full.pt")
    np.savez(tmp_path / "inputs.npz", **batch)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(widths, f)
    loss, grads = Trainer(model, schedules.constant(1e-3)).loss_and_grads(
        dict(model.named_parameters()), batch)
    _run_ranks("grads", 4, tmp_path)
    got = torch.load(tmp_path / "grads.pt", weights_only=True)
    assert got["loss"] == pytest.approx(float(loss), rel=1e-5)
    assert set(got["grads"]) == set(grads)
    for key, want in grads.items():
        assert got["grads"][key].shape == want.shape, key
        _close_to_peak(got["grads"][key].numpy(), want.numpy(), key)


# The uneven-head config of the tests below: 6 heads of 8 at width 48 and
# MLP 64, over 4 model ranks (2, 2, 1 and 1 heads; 16 of the MLP each).
UNEVEN = {"hidden_size": 48, "heads": 6, "intermediate_size": 64}


@pytest.mark.parametrize("folded", [False, True])
def test_uneven_heads_shard_and_unshard_bit_for_bit(folded):
    """Over 4 ranks the 6 heads split 2, 2, 1, 1: each rank's model has
    its run of heads (to_qkv's rows of q, k and v for them and, folded,
    of its bias; to_out's columns), the MLP's even quarter; the slices
    load into those models and round-trip bit for bit."""
    cfg = S.MultiModalModelConfig(fact_model=tiny_fact_config(**UNEVEN))
    whole = builder.build(cfg, is_training=False, device="cpu",
                          ln_affine_folded=folded)
    gen = torch.Generator().manual_seed(3)
    full = {k: torch.randn(v.shape, generator=gen)
            for k, v in whole.state_dict().items()}
    heads = mesh_lib.attention_heads(whole)
    assert set(heads.values()) == {6} and len(heads) == 6
    shards = []
    for r in range(4):
        mesh = mesh_lib.Mesh(1, 4, r)
        shard = mesh_lib.shard_state_dict(full, mesh, heads)
        rank_model = builder.build(cfg, is_training=False, device="cpu",
                                   mesh=mesh, ln_affine_folded=folded)
        rank_model.load_state_dict(shard)  # the shapes fit the rank's
        start, count = mesh_lib.head_split(6, 4, r)
        attn = rank_model.cross_modal_layer.transformer.block_1.attn
        assert (attn.head_start, attn.heads) == (start, count)
        prefix = "cross_modal_layer.transformer.block_1.attn."
        rows = [s * 48 + h * 8 + j for s in range(3)
                for h in range(start, start + count) for j in range(8)]
        assert torch.equal(shard[prefix + "to_qkv.weight"],
                           full[prefix + "to_qkv.weight"][rows])
        if folded:
            assert torch.equal(shard[prefix + "to_qkv.bias"],
                               full[prefix + "to_qkv.bias"][rows])
        assert torch.equal(shard[prefix + "to_out.weight"],
                           full[prefix + "to_out.weight"][
                               :, start * 8:(start + count) * 8])
        assert shard[prefix.replace("attn.", "mlp.") + "fc1.weight"
                     ].shape == (16, 48)
        shards.append(shard)
    back = mesh_lib.unshard_state_dict(shards)
    assert list(back) == list(full)
    for key in full:
        assert torch.equal(back[key], full[key]), key
    with pytest.raises(ValueError, match="head count"):
        mesh_lib.shard_state_dict(full, mesh_lib.Mesh(1, 4, 0))


def test_uneven_heads_over_4_ranks_match_one_rank(tmp_path):
    """4 gloo ranks holding 2, 2, 1 and 1 of 6 heads give the single-rank
    port's f32 loss within 1e-5 relative and every gradient, gathered
    whole from the ranks' unequal slices, within 1e-5 of its leaf's
    peak."""
    from mint_tpu_torch.train import Trainer, schedules

    model = FACT(tiny_fact_config(**UNEVEN))
    init_params(model, torch.Generator().manual_seed(4))
    with torch.no_grad():  # LayerNorm affines off 1 and 0
        gen = torch.Generator().manual_seed(5)
        for name, p in model.named_parameters():
            if ".norm_" in name:
                p.add_(0.3 * torch.randn(p.shape, generator=gen))
    rng = np.random.default_rng(9)
    batch = {"motion_input": rng.standard_normal((3, 8, 9), np.float32),
             "audio_input": rng.standard_normal((3, 16, 35), np.float32),
             "target": rng.standard_normal((3, 4, 9), np.float32)}
    torch.save(model.state_dict(), tmp_path / "full.pt")
    np.savez(tmp_path / "inputs.npz", **batch)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(UNEVEN, f)
    loss, grads = Trainer(model, schedules.constant(1e-3)).loss_and_grads(
        dict(model.named_parameters()), batch)
    _run_ranks("grads", 4, tmp_path)
    got = torch.load(tmp_path / "grads.pt", weights_only=True)
    assert got["loss"] == pytest.approx(float(loss), rel=1e-5)
    assert set(got["grads"]) == set(grads)
    for key, want in grads.items():
        assert got["grads"][key].shape == want.shape, key
        _close_to_peak(got["grads"][key].numpy(), want.numpy(), key)


def test_padded_batch_size_rounds_to_the_data_axis():
    """The JAX rule, with `data` for its mesh's data-axis size."""
    for n_real in range(1, 20):
        for data in (1, 2, 3, 6):
            for cap in (None, 4, 8):
                want = decoder.padded_batch_size(n_real, cap=cap)
                want += (-want) % data
                assert decoder.padded_batch_size(n_real, data=data,
                                                 cap=cap) == want
    assert decoder.padded_batch_size(3, data=6) == 6
    assert decoder.padded_batch_size(5, data=2, cap=4) == 6


# -- over ranks ----------------------------------------------------------------

def test_tensor_parallel_forward_matches_jax(tmp_path):
    """2 ranks, each with half the heads and half the MLP width, give the
    JAX forward on a (1, 2) mesh within 1e-5 of the output's peak."""
    jax_model, params, model = _jax_pair(seed=1)
    rng = np.random.default_rng(0)
    inputs = {"motion_input": rng.standard_normal((3, 8, 9), np.float32),
              "audio_input": rng.standard_normal((3, 16, 35), np.float32)}
    torch.save(model.state_dict(), tmp_path / "full.pt")
    np.savez(tmp_path / "inputs.npz", **inputs)
    mesh = make_mesh(1, 2, devices=jax.devices()[:2])
    sharded = jax.device_put(params, jax_mesh.params_shardings(params, mesh))
    want = np.asarray(jax.jit(jax_model.apply)(
        sharded, {k: jnp.asarray(v) for k, v in inputs.items()}))
    _run_ranks("forward", 2, tmp_path)
    got = np.load(tmp_path / "out.npy")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _close_to_peak(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max(), err_msg=what)


def test_train_step_on_a_2x2_grid_matches_jax(tmp_path):
    """One step with clipping on a (data 2, model 2) grid of 4 gloo ranks
    against mint_tpu's Trainer on make_mesh(2, 2), read from the
    checkpoint rank 0 wrote (whole, unsharded): the loss within 1e-5
    relative, both Adam moments within 1e-5 of each leaf's peak, and the
    parameters within 1e-5 absolute, the port's single-device tolerance
    (tests/test_torch_train.py).  Not 1e-5 of each leaf's peak: Adam's
    first update is lr * g / (|g| + eps), so a zero-initialised bias's
    peak is the rate itself, and an element whose gradient is near eps
    carries the gradient's summation-order error almost whole (the
    single-device port reads 5.8e-4 of such a leaf's peak here)."""
    jax_model, params, model = _jax_pair(seed=2)
    rng = np.random.default_rng(1)
    batch = {"motion_input": rng.standard_normal((4, 8, 9), np.float32),
             "audio_input": rng.standard_normal((4, 16, 35), np.float32),
             "target": rng.standard_normal((4, 4, 9), np.float32)}
    torch.save(model.state_dict(), tmp_path / "full.pt")
    np.savez(tmp_path / "inputs.npz", **batch)

    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    schedule = jax_schedules.manual_stepping([3], [1e-4, 1e-3], warmup=True)
    trainer = JaxTrainer(jax_model, schedule, grad_clip_norm=0.05, mesh=mesh)
    state, metrics = trainer.train_step(trainer.init_state(params),
                                        trainer.shard_batch(batch))
    # The limit really clips.
    grads = jax.grad(lambda p: jnp.mean(jnp.square(
        batch["target"] - jax_model.apply(p, batch)[:, :4])))(params)
    assert float(jnp.sqrt(sum(jnp.sum(g * g) for g in
                              jax.tree_util.tree_leaves(grads)))) > 0.1

    _run_ranks("train", 4, tmp_path)
    with open(tmp_path / "metrics.json") as f:
        got = json.load(f)
    assert got["loss"] == pytest.approx(float(metrics["loss"]), rel=1e-5)
    ckpt = tmp_path / "ckpt" / "1"
    saved = torch.load(ckpt / "params.pt", weights_only=True)
    rest = torch.load(ckpt / "opt_state.pt", weights_only=True)
    assert rest["step"] == 1 and rest["opt_state"]["count"] == 1
    adam = state.opt_state[1]
    for name, tree, want_tree in (
            ("params", saved, state.params),
            ("mu", rest["opt_state"]["mu"], adam.mu),
            ("nu", rest["opt_state"]["nu"], adam.nu)):
        want = weights.from_jax_params(
            jax.tree_util.tree_map(np.asarray, want_tree), model)
        assert set(tree) == set(want)
        for key in want:  # whole tensors: the model's own shapes
            assert tree[key].shape == want[key].shape, key
            if name == "params":
                np.testing.assert_allclose(tree[key].numpy(),
                                           want[key].numpy(), rtol=0,
                                           atol=1e-5, err_msg=key)
            else:
                _close_to_peak(tree[key].numpy(), want[key].numpy(),
                               f"{name} {key}")


def test_world_of_one_trains_as_one_device():
    """A mesh of one gloo rank runs the collective path (the all-reduce
    of the loss and gradients, the clip's norm) and gives one device's
    steps bit for bit, with a clip that bites."""
    import torch.distributed as dist
    from mint_tpu_torch.train import Trainer, schedules

    _, _, model = _jax_pair(seed=6)
    rng = np.random.default_rng(8)
    batches = [{"motion_input": rng.standard_normal((2, 8, 9), np.float32),
                "audio_input": rng.standard_normal((2, 16, 35), np.float32),
                "target": rng.standard_normal((2, 4, 9), np.float32)}
               for _ in range(3)]
    states = {}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        for mesh in (None, mesh_lib.make_mesh(1, 1)):
            trainer = Trainer(model, schedules.constant(1e-3),
                              grad_clip_norm=0.05, mesh=mesh)
            state = trainer.init_state(model)
            losses = []
            for b in batches:
                state, metrics = trainer.train_step(state, b)
                losses.append(float(metrics["loss"]))
            states[mesh is None] = (losses, state)
    finally:
        dist.destroy_process_group()
    (l1, s1), (l0, s0) = states[True], states[False]
    assert l1 == l0
    for k in s1.params:
        assert torch.equal(s1.params[k], s0.params[k]), k
        assert torch.equal(s1.opt_state["mu"][k], s0.opt_state["mu"][k]), k


def test_leaving_releases_the_graphs_that_hold_collectives(monkeypatch):
    """Graphs captured with collectives (thread-local captures) are
    destroyed before the process group is (NCCL waits for them there);
    other graphs stay; a released step captures anew at its next call."""
    import contextlib

    from mint_tpu_torch.utils import graphs
    from test_torch_decoder import FakeCuda

    class Cuda(FakeCuda):
        @contextlib.contextmanager
        def graph(self, graph, pool=None, stream=None, **mode):
            yield

    monkeypatch.setattr(graphs, "_cuda", Cuda())
    calls = []
    cache = graphs.Graphs()
    steps = {name: graphs.Step(lambda: calls.append(1), cache, name,
                               torch.device("cpu"), thread_local=local)
             for name, local in (("nccl", True), ("plain", False))}
    for step in steps.values():
        step()  # eager
        step()  # capture
        assert step.captured
    graphs.release_collectives()
    assert not steps["nccl"].captured and steps["plain"].captured
    steps["nccl"]()  # captures anew
    assert steps["nccl"].captured
    graphs.release_collectives()


def test_dryrun_over_4_gloo_ranks():
    """The twin of __graft_entry__.dryrun_multichip on the CPU: 4 gloo
    ranks (data 2 x model 2) train clipped steps as one device does,
    sampled steps from a replicated and a sharded corpus, and the
    evaluator over 4 replicas decodes as one."""
    out = dryrun(4, device="cpu", steps=2, batch=8, timeout=TIMEOUT)
    assert "mesh {'data': 2, 'model': 2} of 4 cpu ranks" in out


# -- the device dataset over a data axis ---------------------------------------

def test_device_dataset_seeds_and_shards_by_data_index():
    """Data index 0 draws what one device draws; another data index draws
    other windows; the ranks of one model group draw the same; with
    shard_over_data each rank keeps its round-robin share, padded to the
    largest share by cycling its own sequences."""
    rng = np.random.default_rng(3)
    motions = [np.full((20 + i, 9), i, np.float32) for i in range(5)]
    audios = [rng.standard_normal((20 + i, 35)).astype(np.float32)
              for i in range(5)]
    geometry = dict(motion_input_len=8, target_len=4, target_shift=8,
                    audio_input_len=16, batch_size=8, device="cpu")

    def draw(mesh, shard=False):
        dset = DeviceDataset.from_sequences(motions, audios, mesh=mesh,
                                            shard_over_data=shard,
                                            **geometry)
        return dset, dset.sample(7, 3)

    one = DeviceDataset.from_sequences(motions, audios, **geometry)
    _, d0 = draw(mesh_lib.Mesh(2, 1, 0))
    _, d1 = draw(mesh_lib.Mesh(2, 1, 1))
    _, d1_other_model_rank = draw(mesh_lib.Mesh(2, 2, 3))
    assert d0["target"].shape[0] == 4
    whole = one.sample(7, 3)
    # Same seed, fewer rows: the first 4 draws of one device's 8.
    for k in whole:
        assert torch.equal(d0[k], draw_rows(one, 7, 3, 4)[k])
    assert not torch.equal(d0["motion_input"], d1["motion_input"])
    for k in d1:
        assert torch.equal(d1[k], d1_other_model_rank[k])
    for index in range(2):
        dset, batch = draw(mesh_lib.Mesh(2, 1, index), shard=True)
        assert dset.n_sequences == len(range(index, 5, 2))
        assert len(dset._slots) == 3  # ceil(5 / 2) slots
        own = {float(v) for v in batch["motion_input"][:, 0, 0]}
        assert own <= set(range(index, 5, 2))
    assert whole["target"].shape[0] == 8


def draw_rows(dset, seed, step, rows):
    """`rows` windows drawn as `dset` draws with its own batch size."""
    batch_size = dset.batch_size
    dset.batch_size = rows
    try:
        return dset.sample(seed, step)
    finally:
        dset.batch_size = batch_size


# -- decode over replicas ------------------------------------------------------

def _eval_data(model, lengths, seed=5):
    rng = np.random.default_rng(seed)
    audio_seq = model.audio_seq_length
    return [{"motion_input": rng.standard_normal(
                (1, model.motion_seq_length, model.motion_dim), np.float32),
             "audio_input": rng.standard_normal(
                 (1, n + audio_seq - 1, 35), np.float32),
             "motion_name": [f"clip{i}".encode()],
             "audio_name": [b"audio"]}
            for i, n in enumerate(lengths)]


def test_evaluator_over_two_replicas(tmp_path):
    """Two CPU replicas write the one device's clips exactly, and the JAX
    evaluator's on a (2, 1) mesh within the decoder's tolerance; a
    partial batch of 3 pads to 4, two rows a replica."""
    jax_model, params, model = _jax_pair(seed=3)
    model.eval()
    data = _eval_data(model, (12, 12, 12, 7, 9))
    kw = dict(steps=12, steps_bucket=4, decode_batch=4)
    Evaluator(model, data, output_dir=str(tmp_path / "one"), **kw).evaluate()
    two = Evaluator(model, data, output_dir=str(tmp_path / "two"),
                    devices=["cpu", "cpu"], **kw)
    assert len(two.replicas) == 2
    two.evaluate()
    JaxEvaluator(jax_model, data, output_dir=str(tmp_path / "jax"),
                 mesh=make_mesh(2, 1, devices=jax.devices()[:2]),
                 **kw).evaluate(params)
    files = sorted(os.listdir(tmp_path / "one"))
    assert len(files) == 5 and files == sorted(os.listdir(tmp_path / "two"))
    for f in files:
        got = np.load(tmp_path / "two" / f)
        np.testing.assert_array_equal(got, np.load(tmp_path / "one" / f))
        np.testing.assert_allclose(got, np.load(tmp_path / "jax" / f),
                                   rtol=2e-4, atol=2e-5, err_msg=f)
    assert Evaluator(model, data, devices=["cpu"] * 2).decode_batch == 64


def test_replicas_copy_the_weights_and_split_rows_in_order():
    _, _, model = _jax_pair(seed=4)
    model.eval()
    replicas = Replicas(model, ["cpu"] * 3)
    assert replicas.models[0] is model
    assert all(m is not model for m in replicas.models[1:])
    new = {k: v + 1 for k, v in model.state_dict().items()}
    replicas.load_state_dict(new)
    for m in replicas.models:
        for k, v in m.state_dict().items():
            assert torch.equal(v, new[k])
    rng = np.random.default_rng(6)
    inputs = {"motion_input": rng.standard_normal((6, 8, 9), np.float32),
              "audio_input": rng.standard_normal((6, 20, 35), np.float32)}
    got = replicas.decode(inputs, steps=5)
    want = decoder.infer_auto_regressive(model, inputs, steps=5).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="does not split over 3"):
        replicas.decode({k: v[:4] for k, v in inputs.items()}, steps=5)
    assert devices_for("cpu", 0) == [torch.device("cpu")]
    assert devices_for("cpu", 2) == [torch.device("cpu")] * 2


def test_server_over_two_replicas():
    """GenerationService over two CPU replicas: three co-batched requests
    pad to 4, two rows a replica, with the one-replica service's frames;
    /stats reports the replicas."""
    _, _, model = _jax_pair(seed=5)
    model.eval()
    audio_seq = model.audio_seq_length
    rng = np.random.default_rng(7)
    audios = [rng.standard_normal((n + audio_seq - 1, 35), np.float32)
              for n in (5, 6, 7)]
    results = {}
    for n in (1, 2):
        service = GenerationService(model, batch_window_ms=500,
                                    max_batch=4, steps_bucket=8,
                                    devices=["cpu"] * n)
        try:
            assert service.stats_snapshot()["replicas"] == n
            outs = [None] * 3

            def ask(i):
                outs[i] = service.generate(audios[i], steps=20)

            threads = [threading.Thread(target=ask, args=(i,))
                       for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            stats = service.stats_snapshot()
            assert stats["batches"] == 1 and stats["requests"] == 3
            results[n] = outs
        finally:
            service.close()
    for a, b in zip(results[1], results[2]):
        np.testing.assert_array_equal(a, b)
