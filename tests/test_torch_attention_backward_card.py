"""The attention backward kernels (mint_tpu_torch/csrc/attention_bwd.cu)
on the card: against their plain version
(``ops.attention.attention_backward_reference``, the same arithmetic and
cast points in PyTorch) at the flagship's training shapes on the model's
own views, bit for bit from call to call and through a CUDA graph, and
the route every attention call of a flagship training step takes.

Every test here needs a CUDA card (marker ``card``) and skips without
one.  This file imports no JAX, so it runs on the card's machine, which
has none, without ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_attention_backward_card.py

Tolerance against the plain version: 2 bf16 ulps at each gradient's
peak.  Both round P and dS to bf16 where the formula does and every
gradient once; their f32 sums run in other orders, so one of those
roundings may flip.
"""

import math
import os

import numpy as np
import pytest
import torch

from mint_tpu_torch.ops import attention as att

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "fact_v5_deeper_t10_cm12.config")
SCALE = 800 ** -0.5

pytestmark = pytest.mark.card


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _fused(gen, b, n, h, d):
    """q, k, v as the model makes them: strided views of one fused QKV
    output [B, N, 3, H, D]; and the output's gradient as the model hands
    it back, the merged heads' [B, N, H * D] gradient as a [B, H, N, D]
    view."""
    buf = torch.randn(b, n, 3, h, d, device="cuda", generator=gen)
    q, k, v = buf.bfloat16().permute(2, 0, 3, 1, 4).unbind(0)
    do = torch.randn(b, n, h * d, device="cuda", generator=gen).bfloat16()
    return q, k, v, do.view(b, n, h, d).transpose(1, 2)


def _ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def _check(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        err = (g.float() - w.float()).abs().max().item()
        tol = 2 * _ulp(w.float().abs().max().item())
        assert err <= tol and bool(torch.isfinite(g).all()), (name, err, tol)


@pytest.mark.parametrize("b,n", [(32, 360), (32, 240), (32, 120), (8, 360)])
def test_kernels_match_plain_version_on_model_views(gen, b, n):
    q, k, v, do = _fused(gen, b, n, 10, 80)
    assert att.backward_kernels(q, k, v) == att.BACKWARD_KERNELS
    got = att._backward_call(q, k, v, do, SCALE)
    torch.cuda.synchronize()
    _check(got, att.attention_backward_reference(q, k, v, do, SCALE))


@pytest.mark.parametrize("b,h,nq,nk,d", [
    (2, 3, 37, 53, 16), (2, 4, 130, 200, 128), (2, 5, 64, 64, 104),
    (3, 2, 1, 70, 8), (1, 2, 200, 1, 48), (2, 3, 97, 97, 72)])
def test_kernels_match_plain_version_at_other_shapes(gen, b, h, nq, nk, d):
    """Nq != Nk, partial tiles, one query or one key, and head dims on
    instances of each tile layout (16: one narrow slab, 48: three, 72 in
    80: a wide and a narrow one, TMA's zeros past 72; 104 in 112, 128: two
    wide ones) on contiguous tensors."""
    q = torch.randn(b, h, nq, d, device="cuda", generator=gen).bfloat16()
    k, v = (torch.randn(b, h, nk, d, device="cuda", generator=gen).bfloat16()
            for _ in range(2))
    do = torch.randn(b, h, nq, d, device="cuda", generator=gen).bfloat16()
    got = att._backward_call(q, k, v, do, 0.3)
    torch.cuda.synchronize()
    _check(got, att.attention_backward_reference(q, k, v, do, 0.3))


def test_two_calls_give_equal_bits(gen):
    q, k, v, do = _fused(gen, 32, 360, 10, 80)
    first = att._backward_call(q, k, v, do, SCALE)
    second = att._backward_call(q, k, v, do, SCALE)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_graph_replay_equals_eager_call(gen):
    """Captured once, replayed on new inputs copied into the captured
    tensors: the same bits as an eager call on them."""
    q, k, v, do = _fused(gen, 8, 360, 10, 80)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        att._backward_call(q, k, v, do, SCALE)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = att._backward_call(q, k, v, do, SCALE)
    for t, new in zip((q, k, v, do), _fused(gen, 8, 360, 10, 80)):
        t.copy_(new)
    graph.replay()
    eager = att._backward_call(q, k, v, do, SCALE)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))


def _route_cases():
    """Views on either side of the backward kernels' rule: the model's,
    heads of 72, 20 and 136, a dim of 1 whose stride is off a 16-byte
    step, a base 2 bytes off one, and a token stride off one."""
    def fused(b, n, h, d):
        return torch.zeros(b, n, 3, h, d, device="cuda",
                           dtype=torch.bfloat16).permute(
            2, 0, 3, 1, 4).unbind(0)

    def strided(shape, stride, offset=0):
        base = torch.zeros(4 * math.prod(shape) + 64, device="cuda",
                           dtype=torch.bfloat16)
        t = base[offset:].as_strided(shape, stride)
        return t, t, t

    return {"model_views": lambda: fused(2, 70, 10, 80),
            "head_72": lambda: fused(2, 70, 4, 72),
            "head_20": lambda: fused(2, 70, 4, 20),
            "head_136": lambda: fused(2, 70, 4, 136),
            "batch_of_one_stride_off": lambda: strided(
                (1, 2, 70, 80), (3, 70 * 80, 80, 1)),
            "base_off": lambda: strided((2, 2, 70, 80),
                                        (2 * 70 * 80, 70 * 80, 80, 1), 1),
            "token_stride_off": lambda: strided((2, 2, 70, 80),
                                                (2 * 70 * 84, 70 * 84, 84, 1))}


@pytest.mark.parametrize("case", list(_route_cases()))
def test_route_is_what_the_c_entry_takes(gen, case):
    """backward_kernels names the kernels exactly where the C entry
    (mint_attention_bwd_bf16) takes the views: elsewhere the entry refuses
    them and the call raises."""
    q, k, v = _route_cases()[case]()
    do = torch.randn(q.shape, device="cuda", generator=gen).bfloat16()
    try:
        att._backward_call(q, k, v, do, SCALE)
        torch.cuda.synchronize()
        taken = True
    except RuntimeError:
        taken = False
    assert taken == bool(att.backward_kernels(q, k, v)), case


def _flagship_trainer(batch_size):
    """A Trainer of the flagship at full width and depth with bf16
    compute on the card, its parameters, and a batch of `batch_size`."""
    from mint_tpu_torch.config.schema import load_pipeline_config
    from mint_tpu_torch.models import builder
    from mint_tpu_torch.models.fact import init_params
    from mint_tpu_torch.train import Trainer, schedules

    cfg = load_pipeline_config(CONFIG).multi_modal_model
    model = init_params(builder.build(cfg, is_training=True,
                                      dtype=torch.float32, device="cuda",
                                      compute_dtype=torch.bfloat16),
                        torch.Generator().manual_seed(0))
    trainer = Trainer(model, schedules.constant(0.0))
    rng = np.random.default_rng(3)
    batch = {name: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) * 0.5).cuda()
        for name, shape in (("motion_input", (batch_size, 120, 225)),
                            ("audio_input", (batch_size, 240, 35)),
                            ("target", (batch_size, 20, 225)))}
    return model, trainer, batch


def test_graphed_training_steps_count_16_each(gen):
    """Trainer.train_step through its CUDA graph: the first step eager,
    the second captured and replayed, the third a replay; each adds 16 to
    backward_launches (the capture's calls taken back, every replay's
    added) and nothing to backward_plain."""
    from mint_tpu_torch.utils import graphs

    model, trainer, batch = _flagship_trainer(8)
    state = trainer.init_state(model)
    plain = att.backward_plain
    added = []
    for _ in range(3):
        before = att.backward_launches
        state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        added.append(att.backward_launches - before)
    assert graphs.of(model).captures == 1
    assert added == [16, 16, 16]
    assert att.backward_plain == plain


def test_flagship_training_step_takes_the_kernels(gen):
    """One eager forward and backward of the flagship at batch 32 with
    bf16 compute: all 16 attention calls go through the backward kernels,
    none through the plain VJP, and every gradient is finite."""
    model, trainer, batch = _flagship_trainer(32)
    params = trainer.init_state(model).params
    before = (att.backward_launches, att.backward_plain)
    _, grads = trainer.loss_and_grads(params, batch)
    torch.cuda.synchronize()
    assert att.backward_launches - before[0] == 16
    assert att.backward_plain == before[1]
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
