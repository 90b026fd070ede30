"""The port's scoring path against the JAX package's (CPU): the host
NumPy copies (``fid``, ``features``, ``beat_align``, ``aist``) bit for bit,
``EulerAnglesError``, the ``calculate_scores`` and ``extract_features``
CLIs, and the slice as a whole: evaluator, ground-truth features and
scores from the same weights, corpus and annotations."""

import copy
import os
import pickle

import numpy as np
import pytest
import torch

import jax

from mint_tpu.config import load_pipeline_config as jax_load_config
from mint_tpu.data import aist as jax_aist
from mint_tpu.eval import beat_align as jax_beat
from mint_tpu.eval import features as jax_feat
from mint_tpu.eval import fid as jax_fid
from mint_tpu.eval.evaluator import Evaluator as JaxEvaluator
from mint_tpu.eval.metrics import EulerAnglesError as JaxEuler
from mint_tpu.models import build as jax_build
from mint_tpu.models import init_params as jax_init_params
from mint_tpu.motion import rotation as jax_rot
from mint_tpu.motion import smpl as jax_smpl
from mint_tpu_torch.config.schema import load_pipeline_config
from mint_tpu_torch.data import aist
from mint_tpu_torch.eval import beat_align, features, fid
from mint_tpu_torch.eval.evaluator import Evaluator
from mint_tpu_torch.eval.metrics import EulerAnglesError
from mint_tpu_torch.models import builder, weights
from mint_tpu_torch.motion import smpl
from mint_tpu_torch.tools import calculate_scores, extract_features
from test_torch_train import CONFIG
from test_torch_weights import numpy_tree

RNG = np.random.default_rng(29)


def _joints(t=90):
    """A dancing skeleton: rest joints under smooth random poses."""
    poses = (0.08 * RNG.standard_normal((t, 24, 3))).cumsum(0)
    transl = (0.02 * RNG.standard_normal((t, 3))).cumsum(0)
    return np.asarray(jax_smpl.smpl_joints(poses, transl))


# -- the copies, bit for bit --------------------------------------------------

def test_features_equal_jax_bitwise():
    for t in (2, 31, 90):
        j = _joints(t)
        for name in ("extract_kinetic_features", "extract_manual_features"):
            got = getattr(features, name)(j)
            want = getattr(jax_feat, name)(j)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_fid_equals_jax_bitwise():
    real = RNG.standard_normal((40, 6))
    gen = RNG.standard_normal((30, 6)) * 1.3 + 0.2
    assert fid.frechet_feature_distance(real, gen) == \
        jax_fid.frechet_feature_distance(real, gen)
    for got, want in zip(fid.normalize_by_reference(real, gen),
                         jax_fid.normalize_by_reference(real, gen)):
        np.testing.assert_array_equal(got, want)
    # The eps fallback on a singular product.
    x, y = real.copy(), gen.copy()
    x[:, 0] = y[:, 0] = 0.0
    args = (x.mean(0), np.cov(x, rowvar=False), y.mean(0),
            np.cov(y, rowvar=False))
    assert fid.frechet_distance(*args) == jax_fid.frechet_distance(*args)
    with pytest.raises(ValueError, match=">= 2 clips"):
        fid.frechet_feature_distance(real[:1], gen)


def test_beat_align_equals_jax_bitwise():
    j = _joints(120)
    audio = RNG.standard_normal((300, 35)).astype(np.float32)
    audio[:, 34] = (np.arange(300) % 20 == 0)
    np.testing.assert_array_equal(beat_align.velocity_envelope(j),
                                  jax_beat.velocity_envelope(j))
    for smooth in (1, 3):
        np.testing.assert_array_equal(
            beat_align.kinematic_beats(j, smooth),
            jax_beat.kinematic_beats(j, smooth))
    for start in (0, 12):
        assert beat_align.clip_beat_alignment(j, audio, start) == \
            jax_beat.clip_beat_alignment(j, audio, start)
    assert beat_align.beat_alignment_score([], [3]) == 0.0
    audio[:, 34] = 0
    assert beat_align.clip_beat_alignment(j, audio) is None


def _anno_dir(root, n_train=6, n_test=4, t=100, seed=0):
    """An AIST++-layout annotation directory: split files, an ignore list
    and motions/*.pkl (smpl_poses [T, 72], smpl_scaling [1], smpl_trans
    [T, 3], translation in the scaled units)."""
    rng = np.random.default_rng(seed)
    names = [f"gBR_sBM_cAll_d04_mBR{i % 3}_ch{i:02d}"
             for i in range(n_train + n_test + 1)]
    os.makedirs(os.path.join(root, "splits"))
    os.makedirs(os.path.join(root, "motions"))
    with open(os.path.join(root, "splits", "crossmodal_train.txt"), "w") as f:
        f.write("\n".join(names[:n_train]))
    with open(os.path.join(root, "splits", "crossmodal_val.txt"), "w") as f:
        f.write("\n".join(names[n_train:n_train + n_test // 2]))
    with open(os.path.join(root, "splits", "crossmodal_test.txt"), "w") as f:
        f.write("\n".join(names[n_train + n_test // 2:]))
    with open(os.path.join(root, "ignore_list.txt"), "w") as f:
        f.write(names[-1])  # the last test sequence is ignored
    for name in names:
        with open(os.path.join(root, "motions", f"{name}.pkl"), "wb") as f:
            pickle.dump({
                "smpl_poses": (0.05 * rng.standard_normal((t, 72))).cumsum(0),
                "smpl_scaling": np.array([90.0]),
                "smpl_trans": (2.0 * rng.standard_normal((t, 3))).cumsum(0)
                + [0.0, 90.0, 0.0]}, f)
    return names[:-1]


def test_aist_equals_jax(tmp_path):
    names = _anno_dir(str(tmp_path))
    for split in ("train", "testval", "val", "test"):
        assert aist.load_split(str(tmp_path), split) == \
            jax_aist.load_split(str(tmp_path), split)
    assert aist.load_split(str(tmp_path), "train") + aist.load_split(
        str(tmp_path), "testval") == names
    for got, want in zip(aist.load_motion(str(tmp_path / "motions"),
                                          names[0]),
                         jax_aist.load_motion(str(tmp_path / "motions"),
                                              names[0])):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert aist.audio_name_of(names[0]) == jax_aist.audio_name_of(names[0])


def test_euler_metric_matches_jax():
    rots = jax_rot.aa2rotmat(0.7 * RNG.standard_normal((2, 6, 24, 3)))
    target = np.zeros((2, 6, 225), np.float32)
    target[..., 9:] = np.asarray(rots).reshape(2, 6, 216)
    pred = np.concatenate([target, target[:, :3]], axis=1) + \
        0.1 * RNG.standard_normal((2, 9, 225)).astype(np.float32)
    got, want = EulerAnglesError(24), JaxEuler(24)
    for m in (got, want):
        m.update_state({"target": target}, pred)
        m.update_state({"target": target}, target.copy())
    assert got.result() == pytest.approx(want.result(), abs=1e-5)
    assert got.result() > 0.1
    got.reset_states()
    assert got.result() == 0.0


# -- the CLIs ------------------------------------------------------------------

def _jax_features(anno, out_dir):
    """The JAX package's ground-truth features, as its extract_features
    CLI computes them per sequence (tools/extract_features.py:43-53)."""
    os.makedirs(out_dir)
    motion_dir = os.path.join(anno, "motions")
    for s in (jax_aist.load_split(anno, "train")
              + jax_aist.load_split(anno, "testval")):
        poses, scaling, trans = jax_aist.load_motion(motion_dir, s)
        j = np.asarray(jax_smpl.smpl_joints(
            poses.reshape(-1, 24, 3), trans / scaling))
        np.save(os.path.join(out_dir, f"{s}_kinetic.npy"),
                jax_feat.extract_kinetic_features(j))
        np.save(os.path.join(out_dir, f"{s}_manual.npy"),
                jax_feat.extract_manual_features(j))


def _jax_scores(result_glob, feature_dir, seed_frames, audio_dir):
    """The JAX package's calculate_scores main (tools/calculate_scores.py:
    73-128) from its library functions: FID_k, FID_g, Beat Alignment."""
    import glob

    real = {k: [np.load(f) for f in sorted(glob.glob(
        os.path.join(feature_dir, f"*_{k}.npy")))]
        for k in ("kinetic", "manual")}
    gen = {"kinetic": [], "manual": []}
    beats = []
    recover = jax.jit(jax_rot.recover_to_axis_angles)  # one compile
    for path in sorted(glob.glob(result_glob)):
        motion = np.load(path)[None, seed_frames:]
        aa, transl = recover(motion)
        j = np.asarray(jax_smpl.smpl_joints(np.asarray(aa)[0],
                                            np.asarray(transl)[0]))
        gen["kinetic"].append(jax_feat.extract_kinetic_features(j))
        gen["manual"].append(jax_feat.extract_manual_features(j))
        audio_name = os.path.basename(path)[:-4].split("_")[-1]
        ba = jax_beat.clip_beat_alignment(
            j, np.load(os.path.join(audio_dir, f"{audio_name}.npy")),
            start_frame=seed_frames)
        if ba is not None:
            beats.append(ba)
    return {"fid_k": jax_fid.frechet_feature_distance(real["kinetic"],
                                                      gen["kinetic"]),
            "fid_g": jax_fid.frechet_feature_distance(real["manual"],
                                                      gen["manual"]),
            "beat_align": float(np.mean(beats))}


@pytest.mark.parametrize("workers", [0, 2])
def test_extract_features_cli_matches_jax(tmp_path, workers):
    """Ground-truth features for every non-ignored sequence, inline and
    from two spawned CPU workers, equal the JAX package's within f32 FK
    (the joints differ in the last bits; the features are f64 from them)."""
    anno = str(tmp_path / "anno")
    names = _anno_dir(anno)
    extract_features.main([f"--anno_dir={anno}", f"--save_dir={tmp_path}/port",
                           f"--workers={workers}", "--device=cpu"])
    _jax_features(anno, str(tmp_path / "jax"))
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(f"{n}_{k}.npy" for n in names
                           for k in ("kinetic", "manual"))
    for f in files:
        got, want = np.load(tmp_path / "port" / f), np.load(
            tmp_path / "jax" / f)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=f)


def test_calculate_scores_cli_prints_the_scores(tmp_path, capsys):
    anno = str(tmp_path / "anno")
    _anno_dir(anno)
    extract_features.main([f"--anno_dir={anno}",
                           f"--save_dir={tmp_path}/feat", "--workers=0",
                           "--device=cpu"])
    (tmp_path / "out").mkdir()
    (tmp_path / "audio").mkdir()
    for i in range(3):
        clip = np.zeros((130, 225), np.float32)
        clip[:, 6:9] = (0.01 * RNG.standard_normal((130, 3))).cumsum(0)
        clip[:, 9:] = np.asarray(jax_rot.aa2rotmat(
            0.3 * RNG.standard_normal((130, 24, 3)))).reshape(130, 216)
        np.save(tmp_path / "out" / f"gBR_sBM_cAll_d04_mBR{i}_ch0{i}_mBR{i}.npy",
                clip[None] if i == 0 else clip)  # [1, T, 225] is taken too
        audio = np.zeros((300, 35), np.float32)
        audio[::15, 34] = 1.0
        np.save(tmp_path / "audio" / f"mBR{i}.npy", audio)
    out = calculate_scores.main([
        f"--result_files={tmp_path}/out/*.npy",
        f"--feature_dir={tmp_path}/feat", "--seed_frames=10",
        f"--audio_cache_dir={tmp_path}/audio", "--device=cpu"])
    printed = capsys.readouterr().out
    assert f"Evaluation: FID_k: {out['fid_k']:.4f}, FID_g: " \
           f"{out['fid_g']:.4f}" in printed
    assert f"Beat Alignment Score: {out['beat_align']:.4f} over 3 clips" \
        in printed
    assert all(np.isfinite(out[k]) for k in ("fid_k", "fid_g",
                                              "beat_align"))
    with pytest.raises(FileNotFoundError, match="extract_features"):
        calculate_scores.main([f"--result_files={tmp_path}/out/*.npy",
                               f"--feature_dir={tmp_path}/none",
                               "--device=cpu"])


# -- the slice as a whole -----------------------------------------------------

def _tiny_pipelines():
    """tests/test_tools.py's tiny model in both packages' config schemas:
    the flagship at width 32, one block per transformer, 225-dim motion,
    windows of 12 / 24."""
    out = []
    for load in (jax_load_config, load_pipeline_config):
        cfg = copy.deepcopy(load(CONFIG).multi_modal_model)
        fact = cfg.fact_model
        for tf in [m.model[0].transformer for m in fact.modality] + [
                fact.cross_modal_model.transformer]:
            tf.hidden_size, tf.num_hidden_layers = 32, 1
            tf.num_attention_heads, tf.intermediate_size = 2, 64
        fact.modality_by_name("motion").sequence_length = 12
        fact.modality_by_name("motion").feature_dim = 225
        fact.modality_by_name("audio").sequence_length = 24
        out.append(cfg)
    return out


def test_scores_match_jax_end_to_end(tmp_path):
    """Same weights, eval corpus and AIST++ annotations through the JAX
    evaluator, feature extraction and scorer and through the port's: FID_k,
    FID_g and the Beat Alignment Score agree to 1e-4 relative."""
    jax_cfg, cfg = _tiny_pipelines()
    jax_model = jax_build(jax_cfg, is_training=False)
    # One compiled init, not an eager dispatch per op (~15 s on the CPU).
    params = jax.jit(lambda key: jax_init_params(jax_model, key,
                                                 batch_size=2))(
        jax.random.PRNGKey(3))
    model = builder.build(cfg, is_training=False, device="cpu")
    model.load_state_dict(weights.from_jax_params(numpy_tree(params), model))

    # Eval corpus: 8 clips of 96 generated frames (one shape for every
    # JAX function, compiled once), audio with a beat every 15 frames in
    # column 34 at a phase of its own; the same features are the audio
    # cache Beat Alignment reads.
    os.makedirs(tmp_path / "audio")
    data = []
    for i in range(8):
        audio = RNG.standard_normal((96 + 23, 35)).astype(np.float32)
        audio[:, 34] = (np.arange(96 + 23) + 3 * i) % 15 == 0
        np.save(tmp_path / "audio" / f"mBR{i}.npy", audio)
        data.append({
            "motion_input": 0.5 * RNG.standard_normal(
                (1, 12, 225)).astype(np.float32),
            "audio_input": audio[None],
            "motion_name": [f"gBR_sBM_cAll_d04_mBR{i}_ch0{i}".encode()],
            "audio_name": [f"mBR{i}".encode()]})
    kw = dict(steps=96, decode_batch=8)
    JaxEvaluator(jax_model, data, output_dir=str(tmp_path / "jax_out"),
                 **kw).evaluate(params)
    Evaluator(model, data, output_dir=str(tmp_path / "port_out"),
              **kw).evaluate()

    anno = str(tmp_path / "anno")
    _anno_dir(anno, n_train=10, n_test=6, t=96)  # the clips' length
    _jax_features(anno, str(tmp_path / "jax_feat"))
    extract_features.main([f"--anno_dir={anno}",
                           f"--save_dir={tmp_path}/port_feat",
                           "--workers=0", "--device=cpu"])

    want = _jax_scores(str(tmp_path / "jax_out" / "*.npy"),
                       str(tmp_path / "jax_feat"), 12,
                       str(tmp_path / "audio"))
    got = calculate_scores.scores(
        str(tmp_path / "port_out" / "*.npy"), str(tmp_path / "port_feat"),
        seed_frames=12, audio_cache_dir=str(tmp_path / "audio"),
        device="cpu")
    assert got["beat_clips"] == 8
    for k in ("fid_k", "fid_g", "beat_align"):
        assert np.isfinite(got[k]) and got[k] > 0, (k, got[k])
        assert got[k] == pytest.approx(want[k], rel=1e-4), (k, got, want)
