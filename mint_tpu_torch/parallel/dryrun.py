"""The port over ranks: the twin of the JAX package's
``__graft_entry__.dryrun_multichip`` / ``_dryrun_impl``, and the check
that a mesh of ranks trains, and replicas decode, as one device does.

    python -m mint_tpu_torch.parallel.dryrun 4 \\
        [--config_path=configs/fact_v5_deeper_t10_cm12.config]
    python -m mint_tpu_torch.parallel.dryrun 4 --device=cpu

Starts `n` processes, one rank each: over NCCL, rank r on ``cuda:r``
(the host needs `n` cards), or over gloo on the CPU with
``--device=cpu``.  They form a mesh with a model axis of 2 where ``n`` is
even and at least 4, else a pure data mesh, and load their slices of one
seeded model: the config at ``--config_path``, or the JAX entry's tiny
FACT (its own copy of ``_tiny_fact_config``).  Each rank

(a) counts a forward's kernel launches (on cards: one of each kernel a
    transformer layer);
(b) trains ``--steps`` steps on one global batch of ``--batch`` rows,
    each data rank its own, clipped at half the batch's gradient norm on
    one device, so that the clip bites;
(c) trains two steps drawn from a corpus resident on each rank,
    replicated, then sharded over the data axis.

Rank 0 trains the whole model on its device alone on the same batch and
holds the ranks to it: the losses within 1e-5 relative, every parameter
within 1e-5, both Adam moments (the first carries the clip's factor)
within 1e-4 of each leaf's peak.  Then this process decodes 3 steps of
``2n - 1`` clips by the evaluator over `n` replicas, one a device, and
holds the clips to one replica's within 1e-3.  Any failure, or a rank
that does not finish within ``--timeout``, raises.  :func:`run_ranks`
starts the processes (the tests' and ``chip_smoke.py``'s ranks too).
"""

from __future__ import annotations

import argparse
import faulthandler
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from mint_tpu_torch.config import schema as S

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def tiny_fact_config(hidden_size: int = 32, heads: int = 4,
                     intermediate_size: int = 64) -> S.FACTModelConfig:
    """The JAX entry's tiny FACT: width 32, 2 blocks of 4 heads and MLP
    64 in every transformer, windows of 8 motion (9-dim) and 16 audio
    frames (other widths and head counts on request)."""

    def transformer():
        return S.TransformerConfig(hidden_size=hidden_size,
                                   num_hidden_layers=2,
                                   num_attention_heads=heads,
                                   intermediate_size=intermediate_size)

    def modality(name, seq, dim):
        return S.ModalityConfig(
            feature_name=name, sequence_length=seq, feature_dim=dim,
            model=[S.ModalityModelConfig(transformer=transformer())])

    return S.FACTModelConfig(
        modality=[modality("audio", 16, 35), modality("motion", 8, 9)],
        cross_modal_model=S.CrossModalModelConfig(
            modality_a="motion", modality_b="audio",
            transformer=transformer(),
            output_layer=S.MLPConfig(out_dim=9)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_shape(n: int) -> tuple:
    """(data, model) for `n` ranks: model 2 where n is even and >= 4."""
    model = 2 if n % 2 == 0 and n >= 4 else 1
    return n // model, model


def _config(config_path: Optional[str]) -> S.MultiModalModelConfig:
    if config_path is None:
        return S.MultiModalModelConfig(fact_model=tiny_fact_config())
    return S.load_pipeline_config(config_path).multi_modal_model


def _layers(config: S.MultiModalModelConfig) -> int:
    """The transformer layers of a forward: one launch of each kernel."""
    fact = config.fact_model
    return (sum(m.model[0].transformer.num_hidden_layers
                for m in fact.modality)
            + fact.cross_modal_model.transformer.num_hidden_layers)


def _batch(model, b: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    target = 20 if model.motion_seq_length > 20 else 4
    shapes = {"motion_input": (b, model.motion_seq_length, model.motion_dim),
              "audio_input": (b, model.audio_seq_length, model.audio_dim),
              "target": (b, target, model.motion_dim)}
    return {k: (rng.standard_normal(v) * 0.5).astype(np.float32)
            for k, v in shapes.items()}


def _launches():
    from mint_tpu_torch.ops import attention, layer_norm, mlp
    return {"attention": attention.launches, "fused_mlp": mlp.launches,
            "layer_norm": layer_norm.launches}


def run_rank(args) -> None:
    """One rank.  A rank still running 20 s before the parent's timeout
    prints every thread's stack and exits."""
    from mint_tpu_torch.data.device_dataset import DeviceDataset
    from mint_tpu_torch.models import builder
    from mint_tpu_torch.models.fact import init_params
    from mint_tpu_torch.parallel import mesh as mesh_lib
    from mint_tpu_torch.train import Trainer, schedules

    faulthandler.dump_traceback_later(max(10, args.timeout - 20), exit=True)
    cpu = args.device == "cpu"
    device = torch.device("cpu") if cpu else torch.device("cuda", args.rank)
    if not cpu:
        torch.cuda.set_device(device)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://127.0.0.1:{args.port}",
                            world_size=args.n, rank=args.rank)
    try:
        data, model_ax = mesh_shape(args.n)
        mesh = mesh_lib.make_mesh(data=data, model=model_ax, device=device)
        cfg = _config(args.config_path)
        whole = init_params(builder.build(cfg, True, device="cpu"),
                            torch.Generator().manual_seed(0))
        model = builder.build(cfg, True, device=device, mesh=mesh)
        model.load_state_dict(mesh_lib.shard_state_dict(
            whole.state_dict(), mesh, mesh_lib.attention_heads(model)))
        batch = _batch(whole, args.batch)
        rows = args.batch // data
        mine = {k: v[mesh.data_index * rows:(mesh.data_index + 1) * rows]
                for k, v in batch.items()}
        rate = schedules.constant(1e-4)

        # (a) a forward's launches
        with torch.no_grad():
            Trainer(model, rate, mesh=mesh).loss(
                dict(model.named_parameters()),
                {k: torch.from_numpy(v).to(device) for k, v in mine.items()})
        per_forward = _launches()

        # The clip: half the batch's gradient norm on one device (rank 0's
        # whole model), the same on every rank.
        clip = torch.zeros(1, device=device)
        if mesh.is_chief:
            whole = whole.to(device)
            _, grads = Trainer(whole, rate).loss_and_grads(
                dict(whole.named_parameters()), batch)
            clip[0] = 0.5 * torch.linalg.vector_norm(
                torch.stack([g.norm() for g in grads.values()]))
            del grads
        dist.broadcast(clip, src=0)
        clip = clip.item()

        # (b) clipped steps on one batch, held to one device
        def train(m, b, mesh=None):
            trainer = Trainer(m, rate, grad_clip_norm=clip, mesh=mesh)
            state = trainer.init_state(m)
            losses = []
            for _ in range(args.steps):
                state, metrics = trainer.train_step(state, b)
                losses.append(float(metrics["loss"]))
            return trainer, state, losses

        trainer, state, losses = train(model, mine, mesh)
        print(f"rank {args.rank}: trained {losses}", flush=True)
        opt = state.opt_state
        gathered = mesh_lib.gather_state_dicts(
            [state.params, opt["mu"], opt["nu"]], mesh)
        if mesh.is_chief:
            _, ref, ref_losses = train(whole, batch)
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                         ref_losses))
            params = max((gathered[0][k].to(device) - v).abs().max().item()
                         for k, v in ref.params.items())
            moments = max(
                ((got[k].to(device) - v).abs().max()
                 / v.abs().max().clamp_min(1e-30)).item()
                for got, name in ((gathered[1], "mu"), (gathered[2], "nu"))
                for k, v in ref.opt_state[name].items())
            want = {"attention": _layers(cfg), "fused_mlp": _layers(cfg),
                    "layer_norm": 0}
            name = "CPU" if cpu else torch.cuda.get_device_name(device)
            print(f"mesh {mesh.shape} of {args.n} {args.device} ranks "
                  f"({name}), clip {clip:.4g} (half the gradient norm): "
                  f"losses {losses} vs one device {ref_losses} (worst rel "
                  f"{rel:.2e}, tol 1e-5); after {args.steps} steps "
                  f"parameters max_abs_err {params:.3e} (tol 1e-5), Adam "
                  f"moments {moments:.3e} of their leaf's peak (tol 1e-4); "
                  f"launches a forward of rank 0 {per_forward}", flush=True)
            if (not rel <= 1e-5 or not params <= 1e-5
                    or not moments <= 1e-4
                    or (not cpu and per_forward != want)):
                raise AssertionError("the mesh trains otherwise than one "
                                     "device")
            del whole, ref

        # (c) steps drawn from a corpus on each rank
        rng = np.random.default_rng(0)
        t, n_seq = model.audio_seq_length + 24, max(2, data)
        for shard in (False, True):
            dset = DeviceDataset.from_sequences(
                [rng.standard_normal((t, model.motion_dim)).astype(
                    np.float32) for _ in range(n_seq)],
                [rng.standard_normal((t, model.audio_dim)).astype(
                    np.float32) for _ in range(n_seq)],
                motion_input_len=model.motion_seq_length,
                target_len=mine["target"].shape[1],
                target_shift=model.motion_seq_length,
                audio_input_len=model.audio_seq_length,
                batch_size=args.batch, device=device, mesh=mesh,
                shard_over_data=shard)
            state, metrics = trainer.train_steps_sampled(state, dset, loop=2)
            if not np.isfinite(float(metrics["loss"])):
                raise RuntimeError(f"rank {args.rank}: sampled steps (shard "
                                   f"{shard}) loss {metrics}")
    except BaseException:
        dist.destroy_process_group()
        raise
    mesh_lib.leave()


def replicas_check(n: int, device: str, config_path: Optional[str]) -> None:
    """The evaluator over `n` replicas, one a device, against one replica:
    3 steps of ``2n - 1`` clips (a dispatch the padding rounds up to a
    multiple of `n`), the clips within 1e-3."""
    from mint_tpu_torch.eval.evaluator import Evaluator
    from mint_tpu_torch.models import builder
    from mint_tpu_torch.models.fact import init_params

    devices = (["cpu"] * n if device == "cpu"
               else [f"cuda:{i}" for i in range(n)])
    model = init_params(builder.build(_config(config_path), False,
                                      device=devices[0]),
                        torch.Generator().manual_seed(0))
    steps, clips = 3, 2 * n - 1
    rng = np.random.default_rng(1)
    dataset = [{"motion_input": rng.standard_normal(
                    (1, model.motion_seq_length, model.motion_dim)).astype(
                    np.float32) * 0.5,
                "audio_input": rng.standard_normal(
                    (1, steps + model.audio_seq_length - 1,
                     model.audio_dim)).astype(np.float32) * 0.5,
                "motion_name": [f"c{i}".encode()], "audio_name": [b"a"]}
               for i in range(clips)]
    with tempfile.TemporaryDirectory() as out:
        for name, devs in (("one", devices[:1]), ("all", devices)):
            ev = Evaluator(model, dataset, steps=steps, decode_batch=clips,
                           output_dir=os.path.join(out, name), devices=devs)
            for _ in range(2):  # captures, then concurrent replays
                ev.evaluate()
        err = max(float(np.abs(
            np.load(os.path.join(out, "one", f"c{i}_a.npy"))
            - np.load(os.path.join(out, "all", f"c{i}_a.npy"))).max())
            for i in range(clips))
    print(f"evaluator over {n} replicas ({devices}) vs one: max_abs_err "
          f"{err:.3e}, {clips} clips of {steps} steps (tol 1e-3)",
          flush=True)
    if not err <= 1e-3:
        raise AssertionError("replicas decode otherwise than one device")


def run_ranks(argv: Callable[[int], Sequence[str]], n: int,
              timeout: float, env: Optional[dict] = None) -> List[str]:
    """Start `n` processes from the repository's root, process r running
    ``argv(r)`` (one rank each), and wait for them all within `timeout`
    s; kill any left.  Raise naming every rank that failed or timed
    out, with the end of its output; return every rank's output.  Each
    rank writes to a file of its own, so a rank never blocks on a full
    pipe while its peers wait for it in a collective."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as logs:
        files = [open(os.path.join(logs, f"rank{r}.log"), "w+")
                 for r in range(n)]
        procs = [subprocess.Popen(list(argv(r)), cwd=_REPO, env=env,
                                  stdout=f, stderr=subprocess.STDOUT,
                                  text=True)
                 for r, f in enumerate(files)]
        failed = []
        deadline = time.monotonic() + timeout
        try:
            for r, p in enumerate(procs):
                try:
                    p.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    failed.append(r)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            outs = []
            for f in files:
                f.seek(0)
                outs.append(f.read())
                f.close()
    errors = [f"rank {r} ({'timed out after %s s' % timeout if r in failed
                             else 'rc %d' % p.returncode}):\n"
              f"{outs[r][-3000:]}"
              for r, p in enumerate(procs)
              if r in failed or p.returncode != 0]
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def dryrun(n: int, device: str = "cuda", config_path: Optional[str] = None,
           steps: int = 4, batch: int = 32, timeout: float = 600.0) -> str:
    """Run the dry run over `n` ranks, one process each, on `n` cards
    (NCCL) or with ``device="cpu"`` on the CPU (gloo); raise if a rank
    fails or does not finish within `timeout` s, or if the mesh or the
    replicas compute otherwise than one device.  Returns what rank 0
    printed."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    if device == "cuda":
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"{n} ranks need {n} CUDA cards; "
                               f"{torch.cuda.device_count()} found (pass "
                               f"device='cpu' for gloo ranks on the CPU)")
        from mint_tpu_torch.ops import _build
        _build.library()  # once, before the ranks load it
    if batch % mesh_shape(n)[0]:
        raise ValueError(f"batch {batch} does not split over "
                         f"{mesh_shape(n)[0]} data ranks")
    port = free_port()
    outs = run_ranks(lambda r: [
        sys.executable, "-m", "mint_tpu_torch.parallel.dryrun", str(n),
        f"--rank={r}", f"--port={port}", f"--device={device}",
        f"--steps={steps}", f"--batch={batch}", f"--timeout={timeout}"]
        + ([f"--config_path={config_path}"] if config_path else []),
        n, timeout)
    faulthandler.dump_traceback_later(timeout, exit=True)
    try:
        replicas_check(n, device, config_path)
    finally:
        faulthandler.cancel_dump_traceback_later()
    return outs[0]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", nargs="?", type=int, default=4,
                   help="Number of ranks.")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda: NCCL ranks, one a card; cpu: gloo ranks.")
    p.add_argument("--config_path", default=None,
                   help="A pipeline config (default: the tiny FACT).")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--batch", type=int, default=32,
                   help="The global batch.")
    p.add_argument("--timeout", type=float, default=600,
                   help="Seconds the ranks may take together.")
    p.add_argument("--rank", type=int, default=None,
                   help="Run one rank (the processes dryrun starts).")
    p.add_argument("--port", type=int, default=None)
    args = p.parse_args(argv)
    if args.rank is not None:
        run_rank(args)
        return
    print(dryrun(args.n, args.device, args.config_path, args.steps,
                 args.batch, args.timeout)[-3000:], flush=True)
    data, model = mesh_shape(args.n)
    print(f"dryrun ok on {args.n} {args.device} ranks (data {data} x "
          f"model {model})")


if __name__ == "__main__":
    main()
