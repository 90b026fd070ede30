"""AIST++ -> tfrecord preprocessing CLI of the port (counterpart of
``mint_tpu/tools/preprocessing.py``, the reference tools/preprocessing.py).

    python -m mint_tpu_torch.tools.preprocessing \\
        --anno_dir=/path/to/aist_plusplus_final --audio_dir=/path/to/music \\
        --audio_cache_dir=feats --split=train \\
        --tfrecord_path=data/aist_tfrecord

Same behavior: cache 35-dim audio features per music as .npy; per
sequence, load SMPL motion, normalize translation by scaling, axis-angle ->
rotmats -> [T, 3 + 24*9 = 219]; serialize motion+audio+names+shapes into
``--n_shards`` tfrecord shards with seeded random shard assignment; for
testval, append 10x unpaired (random music) examples.

Audio features and rotations are computed on ``--device``: the card by
default, one track after another in this process, f32 matmuls in true f32
(no TF32); with ``--device=cpu``, ``--audio_workers`` spawned processes
share the tracks (0: inline).  Workers never open the card.  Each track's
seconds of music and of extraction are logged, and their totals.
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing
import os
import random
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from mint_tpu_torch.audio import AudioFeatureExtractor
from mint_tpu_torch.audio.frontend import FPS
from mint_tpu_torch.data import aist
from mint_tpu_torch.data.example import encode_example
from mint_tpu_torch.data.tfrecord import TFRecordWriter
from mint_tpu_torch.motion.rotation import aa2rotmat
from mint_tpu_torch.utils.device import resolve

log = logging.getLogger(__name__)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--anno_dir", default="/mnt/data/aist_plusplus_final/",
                   help="Path to the AIST++ annotation files.")
    p.add_argument("--audio_dir", default="/mnt/data/AIST/music/",
                   help="Path to the AIST wav files.")
    p.add_argument("--audio_cache_dir", default="/tmp/aist_audio_feats/",
                   help="Path to cache dictionary for audio features.")
    p.add_argument("--split", default="train", choices=["train", "testval"],
                   help="Whether do training set or testval set.")
    p.add_argument("--tfrecord_path", default="./data/aist_tfrecord",
                   help="Output path for the tfrecord files.")
    p.add_argument("--n_shards", type=int, default=20,
                   help="Number of output shards.")
    p.add_argument("--audio_workers", type=int, default=4,
                   help="Processes for audio feature extraction with "
                        "--device=cpu (0 = inline); on the card the tracks "
                        "run inline.")
    p.add_argument("--device", default="cuda",
                   help="Device of the audio features and rotations: "
                        "'cuda' (the default) or 'cpu'.")
    return p.parse_args(argv)


def _worker_init() -> None:
    # One thread a worker: the pool is the parallelism.
    torch.set_num_threads(1)


def _extract_one(audio_dir: str, cache_dir: str, name: str,
                 device: str) -> tuple:
    """Cache one music's features; returns (frames, seconds it took)."""
    t0 = time.perf_counter()
    feats = AudioFeatureExtractor(audio_dir, cache_dir=cache_dir,
                                  device=device)(name)
    return feats.shape[0], time.perf_counter() - t0


def create_writers(output_file: str, n_shards: int):
    return [TFRecordWriter("{}-{:0>5d}-of-{:0>5d}".format(
        output_file, i, n_shards)) for i in range(n_shards)]


def motion_to_features(smpl_poses: np.ndarray, smpl_scaling: np.ndarray,
                       smpl_trans: np.ndarray,
                       device: torch.device | str = "cuda") -> np.ndarray:
    """[T, 72] axis-angle + scaling + [T, 3] transl -> [T, 219]
    (preprocessing.py:156-161); the rotations in f32 on `device`."""
    smpl_trans = smpl_trans / smpl_scaling
    t = smpl_poses.shape[0]
    poses = torch.as_tensor(smpl_poses.reshape(t, 24, 3), dtype=torch.float32,
                            device=device)
    rotmats = aa2rotmat(poses).reshape(t, 216).cpu().numpy()
    return np.concatenate([smpl_trans, rotmats], axis=-1).astype(np.float32)


def to_example(motion: np.ndarray, audio: np.ndarray, motion_name: str,
               audio_name: str) -> bytes:
    """Serialize one tf.train.Example (preprocessing.py:54-69 schema)."""
    return encode_example({
        "motion_name": [motion_name.encode("utf-8")],
        "motion_sequence": np.asarray(motion, np.float32).ravel(),
        "motion_sequence_shape": np.asarray(motion.shape, np.int64),
        "audio_name": [audio_name.encode("utf-8")],
        "audio_sequence": np.asarray(audio, np.float32).ravel(),
        "audio_sequence_shape": np.asarray(audio.shape, np.int64),
    })


def extract_audio(args: argparse.Namespace, device: torch.device,
                  audio_names: Sequence[str]) -> None:
    """Cache the features of every track (the features come back to the
    host, so each track's time includes its device work); on the CPU with
    ``--audio_workers``, in a spawned pool."""
    jobs = [(args.audio_dir, args.audio_cache_dir, name, str(device))
            for name in audio_names]
    if args.audio_workers and device.type == "cpu":
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(args.audio_workers, initializer=_worker_init) as pool:
            done = pool.starmap(_extract_one, jobs)
    else:
        done = [_extract_one(*job) for job in jobs]
    music = [(frames - 1) / FPS for frames, _ in done]
    seconds = [took for _, took in done]
    for name, (frames, took), length in zip(audio_names, done, music):
        log.info("audio features of %s: %d frames, %.3f s of music in "
                 "%.4f s", name, frames, length, took)
    if done:
        log.info("audio features: %d tracks, %.3f s of music in %.4f s of "
                 "extraction on %s: %.2f s of music per s", len(done),
                 sum(music), sum(seconds), device.type,
                 sum(music) / max(sum(seconds), 1e-12))


def preprocess(args: argparse.Namespace) -> None:
    """Write the split's tfrecords (and the audio cache)."""
    device = resolve(args.device, "preprocessing")
    # The reference's semantics are f32: no TF32 in the CQT and mel
    # products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(42)
    os.makedirs(os.path.dirname(args.tfrecord_path) or ".", exist_ok=True)
    writers = create_writers("%s-%s" % (args.tfrecord_path, args.split),
                             args.n_shards)
    seq_names = aist.load_split(args.anno_dir, args.split)

    log.info("Pre-compute audio features ...")
    extractor = AudioFeatureExtractor(args.audio_dir,
                                      cache_dir=args.audio_cache_dir,
                                      device=device)
    extract_audio(args, device,
                  sorted({aist.audio_name_of(s) for s in seq_names}))

    motion_dir = os.path.join(args.anno_dir, "motions")

    def write_one(seq_name: str, audio_name: str):
        poses, scaling, trans = aist.load_motion(motion_dir, seq_name)
        motion = motion_to_features(poses, scaling, trans, device)
        audio = extractor(audio_name)
        record = to_example(motion, audio, seq_name, audio_name)
        writers[rng.randint(0, len(writers))].write(record)

    for i, seq_name in enumerate(seq_names):
        log.info("processing %d / %d", i + 1, len(seq_names))
        write_one(seq_name, aist.audio_name_of(seq_name))

    if args.split == "testval":
        log.info("Also add un-paired motion-music data for testing.")
        for i, seq_name in enumerate(seq_names * 10):
            log.info("processing %d / %d", i + 1, len(seq_names) * 10)
            write_one(seq_name,
                      aist.audio_name_of(random.choice(seq_names)))

    for w in writers:
        w.close()


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s: %(message)s")
    preprocess(parse_args(argv))


if __name__ == "__main__":
    main()
