"""EDGE on the port, on the CPU at tiny sizes: the denoiser, guidance, the
DDIM step and the whole long-form sampler against the plain reference
(``tests/edge_reference.py``, float32), the sampler's cached music memory
against the reference's uncached denoiser, the K/V projection counter,
EDGE's hazards, the card's bf16-only refusal, the
``edge_model`` config through the builder and ``EDGEFamily.predict``,
the sampler's spans and stamps, and the fused MLP's erf-GELU route."""

from __future__ import annotations

import filecmp
import os

import pytest
import torch
import torch.nn.functional as F

import edge_reference as ref
from mint_tpu_torch.config import schema as S
from mint_tpu_torch.infer import diffusion
from mint_tpu_torch.models import builder, edge
from mint_tpu_torch.models.multi_modal import EDGEFamily
from mint_tpu_torch.ops import film, mlp
from mint_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(latent_dim=16, ff_size=24, num_layers=2, num_heads=2,
            cond_encoder_layers=2, cond_feature_dim=12, nfeats=7, seq_len=6,
            n_timestep=1000, sampling_steps=5, eta=1.0, guidance_weight=2.0,
            clip_denoised=True)


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def seeded_params(g: dict, seed: int = 1):
    """Every leaf random (biases and LayerNorm affines too), so every term
    of the model shows."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, kind in ref.param_spec(g):
        t = torch.randn(shape, generator=gen)
        out[name] = {"dense": t * (2.0 / sum(shape)) ** 0.5,
                     "bias": 0.1 * t, "ln_scale": 1 + 0.1 * t,
                     "ln_bias": 0.1 * t, "embed": t}[kind]
    return out


def tiny_model(g=TINY, seed: int = 1):
    cfg = S.MultiModalModelConfig(edge_model=S.EDGEModelConfig(**g))
    model = builder.build(cfg, is_training=False, device="cpu")
    params = seeded_params(g, seed)
    model.load_state_dict(params)
    return model, params


def inputs(chunks, g=TINY, seed: int = 2):
    gen = torch.Generator().manual_seed(seed)
    c, n = sum(chunks), g["seq_len"]
    return (torch.randn(c, n, g["cond_feature_dim"], generator=gen),
            torch.randn(c, n, g["nfeats"], generator=gen),
            torch.randn(g["sampling_steps"] - 1, c, n, g["nfeats"],
                        generator=gen))


def both_branches(model, x, cond, tau):
    """The sampler's denoiser through ``EDGEFamily.call``: both branches'
    x0 [2 chunks, ...], the conditional first."""
    return EDGEFamily(model).call({"x": x, "cond": cond,
                                   "times": torch.tensor([float(tau)])})


def test_parameters_carry_the_published_names():
    model, _ = tiny_model()
    spec = {name: shape for name, shape, _ in ref.param_spec(TINY)}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == spec


@pytest.mark.parametrize("keep,tau", [([True, True, True], 999),
                                      ([False, False, False], 500),
                                      ([True, False, True], 19)],
                         ids=["conditional", "unconditional", "mixed"])
def test_denoiser_matches_reference(keep, tau):
    """Each chunk's x0 from the branch `keep` names against the
    reference's denoiser with that keep."""
    model, p = tiny_model()
    cond, x, _ = inputs([3])
    both = both_branches(model, x, cond, tau)
    got = torch.stack([both[i if k else 3 + i] for i, k in enumerate(keep)])
    want = ref.denoise(p, x, cond, torch.full((3,), tau), torch.tensor(keep),
                       TINY)
    assert rel(got, want) <= 1e-5


@pytest.mark.parametrize("j", [0, 2, 4], ids=["first", "middle", "last"])
def test_guided_step_with_clamp_and_stitch_matches_reference(j):
    """One DDIM step of the sampler's body (guidance, the clamp, the
    update and the stitch within songs) from the same state."""
    model, p = tiny_model()
    chunks = [2, 1, 2]
    cond, x, noise = inputs(chunks)
    x = 3 * x  # far past the clamp
    loop = diffusion._Loop(model, sum(chunks))
    with torch.no_grad():
        loop.load(cond, chunks, x, noise)
        loop.index.fill_(j)
        loop.body()
    z = noise[j] if j < len(noise) else torch.zeros_like(x)
    x0, nxt = ref.step(p, x, cond, chunks, j, z, TINY)
    assert rel(loop.x0, x0) <= 1e-5
    assert rel(loop.x, nxt) <= 1e-5
    assert loop.x0.abs().max() <= 1.0
    if j < TINY["sampling_steps"] - 1:  # chunk 1 continues song 0's chunk 0
        half = TINY["seq_len"] // 2
        torch.testing.assert_close(loop.x[1, :half], nxt[1, :half])
        assert not torch.equal(loop.x[2, :half], loop.x[1, half:])


def test_sampler_over_songs_of_unequal_chunks_matches_reference():
    model, p = tiny_model()
    chunks = [3, 1, 2]
    cond, x_t, noise = inputs(chunks)
    songs = diffusion.sample(model, cond, chunks, x_t, noise)
    want = ref.sample(p, cond, chunks, x_t, noise, TINY)
    half = TINY["seq_len"] // 2
    assert [s.shape[0] for s in songs] == [TINY["seq_len"] + half * (k - 1)
                                           for k in chunks]
    for got, w in zip(songs, want):
        assert rel(got, w) <= 1e-5


def test_cached_music_memory_equals_the_uncached_forward():
    """The sampler's form (music keys and values once a dispatch, the
    time tokens' a step) gives the published uncached forward's x0 (the
    reference's denoiser) for both branches, at each of two steps that
    share one music memory."""
    model, p = tiny_model()
    cond, x, _ = inputs([3])
    memory = edge.DispatchMemory(model, 3, torch.float32, "cpu")
    keep = torch.tensor([True] * 3 + [False] * 3)
    with torch.no_grad():
        model.music_memory(cond, memory)
        for tau in (379.0, 19.0):
            cached = model.denoise(x, torch.tensor([tau]), memory)
            uncached = ref.denoise(p, torch.cat([x, x]),
                                   torch.cat([cond, cond]),
                                   torch.full((6,), tau), keep, TINY)
            assert rel(cached, uncached) <= 1e-5


def test_unconditional_memory_is_one_key_set_for_every_chunk():
    model, _ = tiny_model()
    cond, x, _ = inputs([4])
    memory = edge.DispatchMemory(model, 4, torch.float32, "cpu")
    n = TINY["seq_len"] + edge.TIME_TOKENS
    assert all(k.shape == (1, n, TINY["latent_dim"])
               for k in memory.k_null + memory.v_null)
    with torch.no_grad():
        model.music_memory(cond, memory)
        a = model.denoise(x, torch.tensor([99.0]), memory)[4:]
        model.music_memory(-cond, memory)  # other music: same null branch
        b = model.denoise(x, torch.tensor([99.0]), memory)[4:]
    assert torch.equal(a, b)
    for rows, k, _ in memory.groups(0, TINY["seq_len"])[1:]:
        assert rows == 4 * TINY["seq_len"] and k.shape[0] == 1


def test_kv_projections_a_dispatch():
    """One a layer for the music memory, then one a layer a step for the
    time tokens (the published cell: 8 + 50 x 8)."""
    model, _ = tiny_model()
    chunks = [2, 2]
    cond, x_t, noise = inputs(chunks)
    before = edge.kv_projections
    diffusion.sample(model, cond, chunks, x_t, noise)
    layers, steps = TINY["num_layers"], TINY["sampling_steps"]
    assert edge.kv_projections - before == layers + steps * layers


def test_kernel_calls_a_dispatch(monkeypatch):
    """Each kernel wrapper's calls in a bf16 dispatch (a launch each on
    the card) are what ``chip_smoke.py`` phase 13 holds the card's
    launch counts to."""
    import chip_smoke
    from mint_tpu_torch.ops import attention, layer_norm

    g = dict(TINY, num_layers=3)
    cfg = S.MultiModalModelConfig(edge_model=S.EDGEModelConfig(**g))
    model = builder.build(cfg, is_training=False, dtype=torch.bfloat16,
                          device="cpu")
    wrappers = {"attention": (attention, "attention"),
                "fused_mlp": (mlp, "fused_mlp"),
                "film": (film, "film_residual"),
                "film_rotary": (film, "rotary"),
                "layer_norm": (layer_norm, "layer_norm")}
    calls = {k: _record(monkeypatch, *w) for k, w in wrappers.items()}
    before = edge.kv_projections
    EDGEFamily(model).predict({"cond": torch.randn(3, g["seq_len"],
                                                   g["cond_feature_dim"]),
                               "chunks": [2, 1]})
    got = {k: len(c) for k, c in calls.items()}
    got["edge_kv_projections"] = edge.kv_projections - before
    want = chip_smoke.edge_expected_launches(cfg.edge_model)
    assert got == {k: n for k, n in want.items() if n}


def _record(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)
    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("hazard", ["scale", "erf", "rotary", "film"])
def test_hazards(hazard, monkeypatch):
    """Scores scaled by head_dim ** -0.5 (0.125 at the published 512 over
    8 heads); GELU's erf form; the rotation on the rows before Q and K and
    never on V or the output; FiLM scaling by (1 + gamma)."""
    if hazard == "scale":
        assert edge.MultiheadAttention(512, 8).scale == 0.125
        from mint_tpu_torch.ops import attention
        calls = _record(monkeypatch, attention, "attention")
        model, _ = tiny_model()
        cond, x, _ = inputs([1])
        both_branches(model, x, cond, 5)
        head = TINY["latent_dim"] // TINY["num_heads"]
        assert calls and all(a[3] == head ** -0.5 for a, _ in calls)
    elif hazard == "erf":
        calls = _record(monkeypatch, mlp, "fused_mlp")
        model, _ = tiny_model()
        cond, x, _ = inputs([1])
        both_branches(model, x, cond, 5)
        assert calls and all(kw.get("activation") == "erf"
                             for _, kw in calls)
    elif hazard == "rotary":
        from mint_tpu_torch.ops import attention
        calls = _record(monkeypatch, attention, "attention")
        model, _ = tiny_model()
        layer = model.seqTransDecoder.stack[0]
        z = torch.randn(2 * TINY["seq_len"], TINY["latent_dim"])
        table = model.table("cpu")
        normed = film.layer_norm_reference(z, layer.norm1.weight,
                                           layer.norm1.bias, 1e-5)
        rotated = film.rotary_reference(normed, table, TINY["seq_len"])
        with torch.no_grad():
            out = layer.self_attn.self_attend(rotated, normed, 2)
        (q, k, v, _), _ = calls[-1]
        e = TINY["latent_dim"]
        w, b = layer.self_attn.in_proj_weight, layer.self_attn.in_proj_bias
        want_v = F.linear(normed, w[2 * e:], b[2 * e:])
        want_q = F.linear(rotated, w[:e], b[:e])
        torch.testing.assert_close(v.transpose(1, 2).reshape(-1, e), want_v)
        torch.testing.assert_close(q.transpose(1, 2).reshape(-1, e), want_q)
        att = attention.attention_reference(q, k, v, layer.self_attn.scale)
        torch.testing.assert_close(
            out, layer.self_attn.out_proj(att.transpose(1, 2).reshape(-1, e)))
    else:
        h, a = torch.randn(12, 8), torch.randn(12, 8)
        gb = torch.zeros(2, 16)
        torch.testing.assert_close(film.film_residual(h, a, gb, 6), h + a)
        gb[:, :8], gb[:, 8:] = 0.5, 0.25
        torch.testing.assert_close(film.film_residual(h, a, gb, 6),
                                   h + 1.5 * a + 0.25)


def test_rotation_matches_the_reference_rotation():
    table = film.rotary_table(9, 16)
    z = torch.randn(2 * 9, 16)
    torch.testing.assert_close(film.rotary_reference(z, table, 9),
                               ref.rotate(z.view(2, 9, 16)).view(-1, 16))
    # the time tokens: positions 7 and 8 of the memory
    torch.testing.assert_close(film.rotary_reference(z[7:9], table, 2, 7),
                               ref.rotate(z[:9])[7:9])


def test_edge_config_through_the_builder_and_the_family():
    path = os.path.join(REPO, "mint_tpu_torch", "config",
                        "edge_jukebox.config")
    published = S.load_pipeline_config(path).multi_modal_model
    assert published.which() == "edge_model"
    e = published.edge_model
    assert (e.latent_dim, e.ff_size, e.num_layers, e.num_heads,
            e.cond_encoder_layers, e.seq_len, e.cond_feature_dim,
            e.sampling_steps, e.nfeats) == (512, 1024, 8, 8, 2, 150, 4800,
                                            50, 151)
    tiny = " ".join(f"{k}: {str(v).lower()}" for k, v in TINY.items())
    pipeline = S.load_pipeline_config(path, config_override=(
        "multi_modal_model { edge_model { %s } }" % tiny))
    model = builder.build(pipeline.multi_modal_model, is_training=False,
                          device="cpu")
    assert isinstance(model, edge.EDGE)
    family = EDGEFamily(model)
    cond = torch.randn(3, TINY["seq_len"], TINY["cond_feature_dim"])
    songs = family.predict({"cond": cond, "chunks": [2, 1],
                            "generator": torch.Generator().manual_seed(0)})
    assert [tuple(s.shape) for s in songs] == [(9, 7), (6, 7)]
    assert all(torch.isfinite(s).all() for s in songs)
    with pytest.raises(NotImplementedError, match="SMPL"):
        family.loss(None, None)
    with pytest.raises(ValueError, match="generation only"):
        builder.build(pipeline.multi_modal_model, is_training=True,
                      device="cpu")
    with pytest.raises(ValueError, match="FACT"):
        builder.require_fact(pipeline.multi_modal_model, "the server")


def test_edge_on_the_card_is_bf16():
    """The FiLM, rotary and erf-GELU kernels are bf16 alone:
    ``builder.check_edge_limits`` refuses another dtype on the card, and
    takes the published configuration in bf16."""
    path = os.path.join(REPO, "mint_tpu_torch", "config",
                        "edge_jukebox.config")
    e = S.load_pipeline_config(path).multi_modal_model.edge_model
    builder.check_edge_limits(e, torch.bfloat16)
    for dtype in (torch.float32, torch.float16):
        with pytest.raises(ValueError, match="bf16"):
            builder.check_edge_limits(e, dtype)


def test_spans_and_stamp_order_of_a_dispatch(monkeypatch):
    phases = []
    monkeypatch.setattr(profiling, "stamp",
                        lambda slots, phase: phases.append(phase))
    model, _ = tiny_model()
    chunks = [2]
    cond, x_t, noise = inputs(chunks)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        diffusion.sample(model, cond, chunks, x_t, noise)
    names = [e.name for e in prof.events()]
    steps = TINY["sampling_steps"]
    assert names.count("mint.diffuse.memory") == 1
    assert names.count("mint.diffuse.step") == steps
    assert phases == ["begin", "forward", "update"] * steps


def test_recorded_steps_are_the_sampler_states():
    model, p = tiny_model()
    chunks = [3]
    cond, x_t, noise = inputs(chunks)
    record = [(0, 1), (2, 2), (4, 0)]
    out = torch.zeros(3, 3, TINY["seq_len"], TINY["nfeats"])
    diffusion.sample(model, cond, chunks, x_t, noise, record, out)
    assert torch.equal(out[0, 0], x_t[1])
    for i, (j, c) in enumerate(record):
        z = noise[j] if j < len(noise) else torch.zeros_like(x_t)
        x = torch.stack([out[i, 0]] * 3)  # the chunk's own state
        x0, _ = ref.step(p, x, cond[c:c + 1].expand(3, -1, -1), [1, 1, 1],
                         j, z[:3], TINY)
        assert rel(out[i, 1], x0[0]) <= 1e-5


def test_reference_copies_are_identical():
    assert filecmp.cmp(os.path.join(REPO, "tests", "edge_reference.py"),
                       os.path.join(REPO, "port_bench", "reference",
                                    "edge.py"), shallow=False)


@pytest.mark.parametrize("activation", ["tanh", "erf"])
def test_mlp_activation(activation):
    """fc1's GELU by name: erf is F.gelu's exact form, and tanh (FACT's,
    the default) is what it was."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(5, 8, generator=gen)
    w1, b1 = torch.randn(8, 12, generator=gen), torch.randn(12, generator=gen)
    w2, b2 = torch.randn(12, 4, generator=gen), torch.randn(4, generator=gen)
    gelu = (F.gelu if activation == "erf"
            else lambda t: F.gelu(t, approximate="tanh"))
    want = gelu(x @ w1 + b1) @ w2 + b2
    torch.testing.assert_close(
        mlp.fused_mlp(x, w1, b1, w2, b2, activation=activation), want)
    if activation == "tanh":
        assert torch.equal(mlp.fused_mlp(x, w1, b1, w2, b2),
                           mlp.mlp_reference(x, w1, b1, w2, b2))
        assert not torch.allclose(mlp.fused_mlp(x, w1, b1, w2, b2),
                                  mlp.fused_mlp(x, w1, b1, w2, b2,
                                                activation="erf"))
    with pytest.raises(ValueError, match="activation"):
        mlp.fused_mlp(x, w1, b1, w2, b2, activation="relu")


def test_chunk_music_and_stitch():
    feats = torch.arange(12 * 2.0).view(12, 2)
    chunks = diffusion.chunk_music(feats, 6)
    assert chunks.shape == (3, 6, 2)
    assert torch.equal(chunks[1], feats[3:9])
    song = diffusion.stitch_songs(chunks, [3])[0]
    assert torch.equal(song, feats)
    with pytest.raises(ValueError):
        diffusion.chunk_music(feats[:10], 6)
