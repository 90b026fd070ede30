"""FACT configs the JAX package runs at geometries the port's kernels once
refused, against the JAX package on the CPU (f32: the kernels' plain
versions run), and the CPU-side pieces of the kernels that take them.

Each geometry is the flagship's (hidden 800, 10 heads, MLP 3072, motion
225-dim, audio 35-dim) with one field changed, at 1 + 1 + 1 blocks and
short windows (but for the 1320-key case, whose windows are the point).
Tolerances are those of tests/test_torch_model.py (forward: 1e-5
relative and absolute, summation order only), tests/test_torch_decoder.py
(decode: 2e-4 relative, 2e-5 absolute) and tests/test_torch_train.py
(a train step's loss: 1e-5 relative; its gradients: 1e-5 absolute, as
the kernels' gradient tests there hold them).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mint_tpu.infer import decoder as jax_decoder
from mint_tpu.models.fact import FACT as JaxFACT
from mint_tpu.models.fact import l2_loss as jax_l2_loss
from mint_tpu.ops import attention as jax_attention
from mint_tpu_torch.config import schema as S
from mint_tpu_torch.infer import decoder
from mint_tpu_torch.models import weights
from mint_tpu_torch.models.fact import FACT, init_params
from mint_tpu_torch.ops import attention as att
from mint_tpu_torch.ops import mlp
from mint_tpu_torch.train import Trainer, schedules
from test_torch_weights import numpy_tree

BF16_TOL = 2 * 2.0 ** -7  # 2 bf16 ulps, relative to the output's peak
DECODE_STEPS = 4

# One geometry field changed from the flagship's (test_torch_ops.py's
# LIMIT_CASES name the same configs at full depth).
GEOMETRIES = {
    "head_dim_130": dict(hidden=1040, heads=8),
    "head_dim_50": dict(heads=16),
    "head_dim_256": dict(hidden=1024, heads=4),
    "keys_1320": dict(motion_seq=120, audio_seq=1200),
    "keys_720_head_dim_128": dict(hidden=1024, heads=8, motion_seq=120,
                                  audio_seq=600),
    "mlp_width_3070": dict(mlp_width=3070),
    "mlp_width_3080": dict(mlp_width=3080),
    "layer_norm_1040": dict(hidden=1040, heads=13),
    "hidden_804_12_heads": dict(hidden=804, heads=12),
}


def _config(hidden=800, heads=10, mlp_width=3072, motion_seq=12,
            audio_seq=24):
    def transformer():
        return S.TransformerConfig(hidden_size=hidden, num_hidden_layers=1,
                                   num_attention_heads=heads,
                                   intermediate_size=mlp_width)

    def modality(name, seq, dim):
        return S.ModalityConfig(
            feature_name=name, sequence_length=seq, feature_dim=dim,
            model=[S.ModalityModelConfig(transformer=transformer())])

    return S.FACTModelConfig(
        modality=[modality("audio", audio_seq, 35),
                  modality("motion", motion_seq, 225)],
        cross_modal_model=S.CrossModalModelConfig(
            modality_a="motion", modality_b="audio",
            transformer=transformer(),
            output_layer=S.MLPConfig(out_dim=225)))


def _pair(cfg, seed):
    """(JAX model, its params, the port's f32 model) with the same weights:
    the port's seeded initialization as a numpy tree, loaded by both sides
    through the weights bridge."""
    tree = weights.to_numpy_tree(init_params(
        FACT(cfg), torch.Generator().manual_seed(seed)))
    model = FACT(cfg).eval()
    model.load_state_dict(weights.from_jax_params(tree, model))
    return JaxFACT(cfg), jax.tree_util.tree_map(jnp.asarray, tree), model


def _windows(model, rng, b=1, audio_len=None):
    return {"motion_input": rng.standard_normal(
                (b, model.motion_seq_length, 225)).astype(np.float32) * 0.5,
            "audio_input": rng.standard_normal(
                (b, audio_len or model.audio_seq_length, 35)
            ).astype(np.float32) * 0.5}


@pytest.mark.parametrize("case", list(GEOMETRIES))
def test_wide_config_matches_jax(case):
    """The forward, a 4-step decode, and one train step's loss and
    gradients of the port equal the JAX package's on the same weights."""
    jax_model, params, model = _pair(_config(**GEOMETRIES[case]), seed=3)
    rng = np.random.default_rng(11)
    jax_in = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa
    torch_in = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa

    inputs = _windows(model, rng)
    want = np.asarray(jax.jit(jax_model.apply)(params, jax_in(inputs)))
    with torch.no_grad():
        got = model(torch_in(inputs)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    inputs = _windows(model, rng, audio_len=DECODE_STEPS
                      + model.audio_seq_length - 1)
    want = np.asarray(jax_decoder.infer_auto_regressive(
        jax_model, params, jax_in(inputs), steps=DECODE_STEPS))
    got = decoder.infer_auto_regressive(model, inputs, steps=DECODE_STEPS)
    assert got.shape == (1, DECODE_STEPS, 225)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)

    batch = _windows(model, rng)
    batch["target"] = rng.standard_normal((1, 20, 225)).astype(np.float32)

    def jax_loss(p):
        out = jax_model.apply(p, jax_in({k: v for k, v in batch.items()
                                         if k != "target"}))
        return jnp.mean(jax_l2_loss(jnp.asarray(batch["target"]), out))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    want_grads = weights.from_jax_params(numpy_tree(want_grads), model)
    loss, grads = Trainer(model, schedules.constant(0.0)).loss_and_grads(
        dict(model.named_parameters()), batch)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert set(grads) == set(want_grads)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[key].numpy(),
                                   rtol=0, atol=1e-5, err_msg=key)


def _streamed_bf16_attention(q, k, v, scale, tile=64):
    """The bf16 streamed kernel (csrc/attention.cu,
    attention_tc_stream_kernel), in f32 PyTorch on bf16-valued inputs: the
    head dim padded with zeros (as TMA fills them) to the kernel's chunks,
    one up to 256 columns (a multiple of 16), more past it; K and V
    cut into `tile`-key tiles (zeros past Nk).  Pass 1 walks the tiles
    once, each tile's scores computed once over the whole head dim (the
    chunks summed in order), keeping each row's running max and sum of
    exp2 with the keys past Nk masked out; pass 2 walks them again, forms
    the exactly normalised P = exp2(s - max) / sum, rounds it to bf16, and
    accumulates P.V over the whole head dim in f32 a tile at a time; the
    output is rounded to bf16 and cut to D."""
    *lead, nq, d = q.shape
    nk = k.shape[-2]
    chunks = -(-d // 256)
    width = -(-(-(-d // chunks)) // 16) * 16
    tiles = -(-nk // tile)
    pad_d, pad_k = chunks * width - d, tiles * tile - nk
    q = torch.nn.functional.pad(q.float(), (0, pad_d))
    k = torch.nn.functional.pad(k.float(), (0, pad_d, 0, pad_k))
    v = torch.nn.functional.pad(v.float(), (0, pad_d, 0, pad_k))
    scale_log2 = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)

    def scores(t):
        keys = slice(t * tile, (t + 1) * tile)
        s = torch.zeros(*lead, nq, tile)
        for c in range(chunks):
            cols = slice(c * width, (c + 1) * width)
            s = s + q[..., cols] @ k[..., keys, cols].transpose(-1, -2)
        valid = torch.arange(tile) < nk - t * tile
        return torch.where(valid, s * scale_log2, -torch.inf)

    m = torch.full((*lead, nq, 1), -torch.inf)
    l = torch.zeros(*lead, nq, 1)
    for t in range(tiles):
        s = scores(t)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp2(m - m_new) + torch.exp2(s - m_new).sum(
            -1, keepdim=True)
        m = m_new
    out = torch.zeros(*lead, nq, chunks * width)
    for t in range(tiles):
        p = (torch.exp2(scores(t) - m) * (1 / l)).bfloat16().float()
        out = out + p @ v[..., t * tile:(t + 1) * tile, :]
    return out[..., :d].bfloat16()


@pytest.mark.parametrize("d", [50, 80, 130])
@pytest.mark.parametrize("nk", [1217, 1320, 1440])
def test_streamed_bf16_schedule_matches_the_reference(nk, d):
    """Key counts past the resident schedule's limit (1216 at D = 80) and
    head dims that are not a multiple of 16 or over 128: the streamed
    schedule's arithmetic against the plain version in bf16, within 2
    bf16 ulps of the output's peak (both round P and the output)."""
    rng = np.random.default_rng(nk + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, n, d)).astype(
        np.float32)).bfloat16() for n in (64, nk, nk))
    got = _streamed_bf16_attention(q, k, v, 800 ** -0.5)
    want = att.attention_reference(q, k, v, 800 ** -0.5)
    assert got.shape == want.shape == (1, 2, 64, d)
    tol = BF16_TOL * max(1.0, want.float().abs().max().item())
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=0, atol=tol)


def _pallas(q, k, v, scale, dtype):
    """The JAX package's Pallas kernel on the same values (interpret mode
    on the CPU, as its own tests run it), as f32 numpy."""
    out = jax_attention.pallas_attention(
        *(jnp.asarray(t.float().numpy(), dtype) for t in (q, k, v)), scale)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("n,d", [(64, 130), (64, 256), (1320, 80),
                                 (64, 264)])
def test_streamed_bf16_kernel_matches_pallas(n, d):
    """The streamed kernel's arithmetic against the Pallas kernel in bf16:
    head dims over 128 (their scores once over the whole head dim; 264
    past 256, in two chunks) and 1320 keys at FACT's D = 80 (the
    bf16_keys config's cross-modal blocks); within 2 bf16 ulps of the
    output's peak, as _close_bf16 in tests/test_torch_ops.py states (both
    round P and the output to bf16, so one rounding may flip)."""
    rng = np.random.default_rng(n + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, n, d)).astype(
        np.float32)).bfloat16() for _ in range(3))
    got = _streamed_bf16_attention(q, k, v, 800 ** -0.5)
    want = _pallas(q, k, v, 800 ** -0.5, jnp.bfloat16)
    assert got.shape == want.shape == (1, 2, n, d)
    tol = BF16_TOL * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def _wide_f32_attention(q, k, v, scale, rows=128, tile=32):
    """The f32 kernel for heads over 128 (csrc/attention_f32.cu,
    attention_wide_kernel), in f32 PyTorch: blocks of `rows` query rows
    (16 a warp, 8 warps) and output chunks of at most 256 columns (a
    multiple of 4: the kernel's one chunk up to 256 columns; past them,
    where the scores-once kernels run, the chunked form each block of
    which recomputes the scores); for each, one pass over `tile`-key
    tiles, each tile's scores computed over the whole head dim, with the
    online softmax of attention_kernel (a running row max and sum, the
    P.V accumulator rescaled by exp(old max - new max) when the max rises,
    divided by the sum at the end)."""
    *lead, nq, d = q.shape
    nk = k.shape[-2]
    chunks = -(-d // 256)
    dc = -(-(-(-d // chunks)) // 4) * 4
    out = torch.empty(*lead, nq, d)
    for r0 in range(0, nq, rows):
        qb = q[..., r0:r0 + rows, :]
        for c0 in range(0, d, dc):
            m = torch.full((*lead, qb.shape[-2], 1), -torch.inf)
            l = torch.zeros_like(m)
            acc = torch.zeros(*lead, qb.shape[-2], min(dc, d - c0))
            for k0 in range(0, nk, tile):
                s = qb @ k[..., k0:k0 + tile, :].transpose(-1, -2) * scale
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + p @ v[..., k0:k0 + tile, c0:c0 + dc]
                m = m_new
            out[..., r0:r0 + rows, c0:c0 + dc] = acc / l
    return out


@pytest.mark.parametrize("d", [130, 256, 264])
def test_wide_f32_kernel_matches_pallas(d):
    """The f32 kernel for heads over 128 against the Pallas kernel in f32,
    within 1e-5 (summation order only: exact f32 on both sides)."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 200, d)).astype(
        np.float32)) for _ in range(3))
    got = _wide_f32_attention(q, k, v, 800 ** -0.5)
    want = _pallas(q, k, v, 800 ** -0.5, jnp.float32)
    assert got.shape == want.shape == (1, 2, 200, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", [50, 67, 130])
def test_heads_tma_cannot_read_are_padded_with_zeros(d):
    """A bf16 head dim that is not a multiple of 8 (hidden 800 over 16
    heads, 804 over 12, 1040 over 8) reaches the kernel as the model's own
    fused QKV views, copied nowhere: the same storage and strides.  The
    kernels read each head where it lies and zero, in shared memory, the
    columns past d that a load brings with it (csrc/attention.cu; held to
    the plain version on the card by chip_smoke.py).  The output is a
    [B, H, Nq, D] view of new [B, Nq, H, D] storage, as before."""
    heads = {50: 16, 67: 12, 130: 8}[d]
    buf = torch.randn(2, 30, 3, heads, d).bfloat16()
    q, k, v = buf.permute(2, 0, 3, 1, 4).unbind(0)
    assert not any(att._tma_ready(t) for t in (q, k, v))
    *given, out = att._operands(q, k, v)
    for was, got in zip((q, k, v), given):
        assert got.data_ptr() == was.data_ptr()
        assert got.stride() == was.stride() and got.shape == was.shape
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("h,f,o", [(804, 3072, 804), (800, 3080, 800),
                                   (40, 3070, 24), (36, 100, 33)])
def test_bf16_mlp_reads_operands_in_place(h, f, o):
    """At widths TMA cannot address (rows of 1608 bytes at hidden 804, W2's
    of 6140 at F = 3070, odd widths), the bf16 kernel's operands are the
    caller's own tensors: x and nn.Linear's weights (passed as .t() views)
    with the same storage and strides, no padded copy (csrc/mlp.cu loads
    them by cp.async or realigned words where TMA cannot; held to the plain
    version on the card by chip_smoke.py)."""
    fc1 = torch.nn.Linear(h, f).bfloat16()
    fc2 = torch.nn.Linear(f, o).bfloat16()
    x = torch.randn(3, 5, h).bfloat16().reshape(-1, h)
    given = mlp._operands(x, fc1.weight.t(), fc1.bias, fc2.weight.t(),
                          fc2.bias)
    for was, got in zip((x, fc1.weight, fc1.bias, fc2.weight, fc2.bias),
                        given):
        assert got.data_ptr() == was.data_ptr()
        assert got.stride() == was.stride() and got.shape == was.shape


def _plan_of(h, f, o, x_offset=0):
    """bf16_plan for x [5, h] (its base `x_offset` elements into a
    16-byte-aligned buffer) and nn.Linear weights."""
    flat = torch.zeros(5 * h + 16, dtype=torch.bfloat16)
    skip = (-flat.data_ptr() % 16) // 2 + x_offset
    x = flat[skip:skip + 5 * h].view(5, h)
    w1t = torch.zeros(f, h, dtype=torch.bfloat16)
    w2t = torch.zeros(o, f, dtype=torch.bfloat16)
    return mlp.bf16_plan(x, w1t, w2t)


@pytest.mark.parametrize("h,f,o,x_offset,tiles,loads", [
    (800, 3072, 800, 0, (192, 200), ("tma", "tma", "tma", "tma")),
    (804, 3072, 804, 0, (192, 208), ("tma_pairs", "tma_pairs", "tma",
                                     "tma")),
    (800, 3080, 800, 0, (200, 200), ("tma", "tma", "tma", "tma")),
    (800, 3080, 804, 0, (200, 208), ("tma", "tma", "tma", "tma")),
    (804, 3080, 804, 0, (192, 208), ("tma_pairs", "tma_pairs", "tma",
                                     "tma")),
    (804, 3072, 804, 4, (192, 208), ("staged", "staged", "tma", "tma")),
    (800, 3070, 801, 0, (192, 200), ("tma", "tma", "tma", "tma_phases")),
    (800, 3072, 800, 1, (192, 200), ("staged", "tma", "tma", "tma")),
    (800, 3072, 800, 4, (192, 200), ("staged", "tma", "tma", "tma")),
    (33, 70, 17, 0, (192, 200), ("staged", "staged", "tma", "tma_phases")),
    (800, 3068, 800, 0, (192, 200), ("tma", "tma", "tma", "tma_phases")),
    (800, 3071, 804, 0, (192, 200), ("tma", "tma", "tma", "tma_phases")),
])
def test_bf16_plan(h, f, o, x_offset, tiles, loads):
    """The bf16 kernel's plan: each pass takes the fewest column tiles its
    instances allow, the flagship's width on a tie (F = 3072 and 3080 in
    16 tiles, of 192 and 200; O = 800 and 804 in 4, of 200 and 208; a
    width over the tile, as 3080 over 192, would take a 17th tile a few
    columns wide; fc1 on tma_pairs takes 192 alone, fc2 on tma_phases 200
    of the activation's rows), each operand the load its base and row
    stride allow (TMA on 16-byte steps; hidden 804's x and W1^T, rows 8
    bytes past a step, as two TMA maps of every other row, tma_pairs, where
    both are; W2^T at an MLP width no multiple of 8, its rows off the step
    from a base on one, as a TMA map a row phase, tma_phases; else staged),
    the activation TMA's at a row stride of F rounded up to 64 (rows on
    128-byte lines)."""
    plan = _plan_of(h, f, o, x_offset)
    assert plan.tiles == tiles and plan.loads == loads
    assert plan.act_ld == -(-f // 64) * 64
    if f in (3072, 3080) and o in (800, 804) and loads[0] != "tma_pairs":
        assert (-(-f // tiles[0]), -(-o // tiles[1])) == (16, 4)
