"""EDGE's kernels and sampler on the card: the FiLM residual and the
rotation (``csrc/film.cu``) against their plain versions, and what they
refuse; the bf16 fused MLP's erf-GELU on each route against
``mlp_reference(..., "erf")``, the tanh MLP's bits pinned, the f32 erf call
refused; attention at EDGE's shapes; and the published configuration's
sampler graphed against the same steps uncaptured, an f32 EDGE refused.
``chip_smoke.py`` phase 13 checks the same kernels at the diffuse cell's
shapes, timed, with a dispatch's launch counts.

Every test here needs a CUDA card (marker ``card``) and skips without
one.  This file imports no JAX, so it runs on the card's machine without
``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_edge_card.py
"""

import hashlib
import os

import pytest
import torch

from mint_tpu_torch.ops import attention as att
from mint_tpu_torch.ops import film, mlp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.card

# sha256 of the bf16 tanh MLP's output bits for the seeded inputs of
# _tanh_output, from the kernels before the erf epilogue was added (the
# same on an NVIDIA H100 80GB HBM3 with and without it).
TANH_BITS = {
    "7200x800x3072":
        "a071ed0aebab61f1139918cd2cde1a1a6da8d2ff509236a06f812ad3d20edfc7",
    "960x800x3072":
        "87352b21017e87130c9784c71a393f9c543b76540f4367df88942ce03f54ceb6",
    "7200x804x3072":
        "5b1660192d0478bedc993e6035385eab50d075967598fe389ff4ad1da01d3314",
}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("rows,cols", [(36000, 512), (300, 520)],
                         ids=["cell", "few_rows"])
def test_film_residual_is_the_plain_version(gen, rows, cols):
    h = torch.randn(rows, cols, device="cuda", generator=gen).bfloat16()
    a = torch.randn(rows, cols, device="cuda", generator=gen).bfloat16()
    gb = (0.3 * torch.randn(rows // 150, 2 * cols, device="cuda",
                            generator=gen)).bfloat16()
    assert torch.equal(film.film_residual(h, a, gb, 150),
                       film.film_reference(h, a, gb, 150))


@pytest.mark.parametrize("pos0,seq", [(0, 150), (150, 2)])
def test_rotation_with_and_without_layer_norm(gen, pos0, seq):
    table = film.rotary_table(152, 512, "cuda")
    x = torch.randn(300 if seq == 150 else 2, 512, device="cuda",
                    generator=gen).bfloat16()
    if pos0:
        got = film.rotary(x, table, seq, pos0)
        assert torch.equal(got, film.rotary_reference(x, table, seq, pos0))
        return
    w = 1 + 0.1 * torch.randn(512, device="cuda", generator=gen)
    b = 0.1 * torch.randn(512, device="cuda", generator=gen)
    n, r = film.rotary(x, table, seq, 0, w, b, 1e-5, normed=True)
    n_ref = film.layer_norm_reference(x, w, b, 1e-5)
    ulp = (n_ref.float() - n.float()).abs() / n_ref.float().abs().clamp_min(
        1e-3)
    assert float(ulp.max()) <= 2 ** -7  # one bf16 rounding
    assert torch.equal(r, film.rotary_reference(n, table, seq))
    assert torch.equal(film.rotary(x, table, seq, 0, w, b, 1e-5), r)


@pytest.mark.parametrize("m,h,f,off", [(36000, 512, 1024, 0),
                                       (240, 512, 1024, 0),
                                       (960, 804, 3072, 0),
                                       (960, 800, 3072, 1)],
                         ids=["edge", "split", "tma_pairs", "staged"])
def test_erf_mlp_routes(gen, m, h, f, off):
    x = torch.randn(m * h + off, device="cuda",
                    generator=gen).bfloat16()[off:].view(m, h)
    w1 = (torch.randn(f, h, device="cuda", generator=gen) * h ** -0.5
          ).bfloat16()
    b1 = (0.1 * torch.randn(f, device="cuda", generator=gen)).bfloat16()
    w2 = (torch.randn(h, f, device="cuda", generator=gen) * f ** -0.5
          ).bfloat16()
    b2 = (0.1 * torch.randn(h, device="cuda", generator=gen)).bfloat16()
    got = mlp.fused_mlp(x, w1.t(), b1, w2.t(), b2, activation="erf")
    erf = mlp.mlp_reference(x, w1.t(), b1, w2.t(), b2, "erf")
    tanh = mlp.mlp_reference(x, w1.t(), b1, w2.t(), b2, "tanh")
    assert _rel(got, erf) <= 4e-3
    assert _rel(got, erf) < 0.5 * _rel(got, tanh)


def test_film_kernels_refuse_what_they_cannot_read(gen):
    """Rows no multiple of 8 columns (no 16-byte loads), and any dtype
    but bf16 on the card: refused, never run as the plain version."""
    h = torch.randn(300, 510, device="cuda", generator=gen).bfloat16()
    gb = torch.zeros(2, 1020, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="16-byte"):
        film.film_residual(h, h, gb, 150)
    h32 = torch.randn(300, 512, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="float32"):
        film.film_residual(h32, h32, torch.zeros(2, 1024, device="cuda"), 150)
    with pytest.raises(ValueError, match="float32"):
        film.rotary(h32, film.rotary_table(152, 512, "cuda"), 150)


def _tanh_output(m, h, f):
    g = torch.Generator(device="cuda").manual_seed(m + h)
    x = torch.randn(m, h, generator=g, device="cuda").bfloat16()
    w1 = (torch.randn(f, h, generator=g, device="cuda") * h ** -0.5
          ).bfloat16()
    b1 = (torch.randn(f, generator=g, device="cuda") * 0.1).bfloat16()
    w2 = (torch.randn(h, f, generator=g, device="cuda") * f ** -0.5
          ).bfloat16()
    b2 = (torch.randn(h, generator=g, device="cuda") * 0.1).bfloat16()
    return mlp.fused_mlp(x, w1.t(), b1, w2.t(), b2)


@pytest.mark.parametrize("shape", [(7200, 800, 3072), (960, 800, 3072),
                                   (7200, 804, 3072)],
                         ids=["flagship", "split", "tma_pairs"])
def test_tanh_mlp_keeps_its_bits(gen, shape):
    y = _tanh_output(*shape)
    digest = hashlib.sha256(
        y.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
    assert digest == TANH_BITS["%dx%dx%d" % shape]


def test_f32_erf_mlp_is_refused(gen):
    """The f32 kernel's epilogue is tanh alone: an f32 erf call raises
    rather than run as tanh, and launches nothing."""
    x = torch.randn(300, 64, device="cuda", generator=gen)
    w1 = 0.1 * torch.randn(128, 64, device="cuda", generator=gen)
    b1 = torch.randn(128, device="cuda", generator=gen)
    w2 = 0.1 * torch.randn(64, 128, device="cuda", generator=gen)
    b2 = torch.randn(64, device="cuda", generator=gen)
    before = mlp.launches
    with pytest.raises(ValueError, match="bf16"):
        mlp.fused_mlp(x, w1.t(), b1, w2.t(), b2, activation="erf")
    assert mlp.launches == before


@pytest.mark.parametrize("bq,nq,bk,nk", [(240, 150, 240, 150),
                                         (120, 150, 120, 152),
                                         (1, 18000, 1, 152)],
                         ids=["self", "conditional", "unconditional"])
def test_attention_at_edge_shapes(gen, bq, nq, bk, nk):
    q = torch.randn(bq, 8, nq, 64, device="cuda", generator=gen).bfloat16()
    k = torch.randn(bk, 8, nk, 64, device="cuda", generator=gen).bfloat16()
    v = torch.randn(bk, 8, nk, 64, device="cuda", generator=gen).bfloat16()
    got = att.attention(q, k, v, 0.125)
    assert _rel(got, att.attention_reference(q, k, v, 0.125)) <= 4e-3


def test_published_sampler_graphed_is_uncaptured(gen):
    """The published configuration through builder.build and
    EDGEFamily.predict, its steps replaying a graph, against the same
    steps uncaptured."""
    from mint_tpu_torch.config.schema import load_pipeline_config
    from mint_tpu_torch.infer import diffusion
    from mint_tpu_torch.models import builder, edge
    from mint_tpu_torch.models.multi_modal import EDGEFamily

    cfg = load_pipeline_config(os.path.join(
        REPO, "mint_tpu_torch", "config", "edge_jukebox.config"))
    model = builder.build(cfg.multi_modal_model, is_training=False,
                          dtype=torch.bfloat16)
    e = cfg.multi_modal_model.edge_model
    chunks = [2, 1]
    cond = torch.randn(3, e.seq_len, e.cond_feature_dim, device="cuda",
                       generator=gen)
    x_t = torch.randn(3, e.seq_len, e.nfeats, device="cuda", generator=gen)
    noise = torch.randn(e.sampling_steps - 1, 3, e.seq_len, e.nfeats,
                        device="cuda", generator=gen)
    inputs = {"cond": cond, "chunks": chunks, "x_T": x_t, "noise": noise}
    with pytest.raises(ValueError, match="bf16"):
        builder.build(cfg.multi_modal_model, is_training=False,
                      dtype=torch.float32)
    before = edge.kv_projections
    graphed = EDGEFamily(model).predict(inputs)
    assert edge.kv_projections - before == e.num_layers * (
        1 + e.sampling_steps)
    replayed = EDGEFamily(model).predict(inputs)
    eager = diffusion.sample(model, cond, chunks, x_t, noise, graphed=False)
    for a, b, c in zip(graphed, replayed, eager):
        assert torch.equal(a, b) and torch.equal(a, c)
        assert torch.isfinite(a).all()
