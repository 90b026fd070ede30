"""Batched HTTP inference server for dance generation, on the PyTorch port.

Counterpart of ``mint_tpu/serving/server.py``: a micro-batching queue in
front of :func:`mint_tpu_torch.infer.decoder.infer_auto_regressive`, so
concurrent requests ride one decode on the device.

Protocol (npy bodies keep it dependency-free):

- ``POST /generate?steps=N`` — body is one ``.npy`` payload of audio
  features [T_audio, audio_dim] (float32), optionally followed by a second
  concatenated ``.npy`` blob holding the seed motion
  [motion_seq, motion_dim].  Response: ``.npy`` of generated motion
  [steps', motion_dim] where steps' = min(N, T_audio - audio_seq + 1).
- ``GET /healthz`` — liveness + model info.
- ``GET /stats`` — request/batch counters.

Batching: requests wait up to ``batch_window_ms`` (or until
``max_batch``), are bucketed by quantized generatable length, padded to a
power-of-two batch and the bucket's audio length, and decoded in one
batched decode per bucket.

Replicas (``--data_parallelism``, the JAX server's mesh): one process
drives every card, each holding a replica of the parameters; each
bucket's batch is padded to a multiple of the replica count and split
over them by rows (``parallel/replicas.py``).  ``/stats`` reports the
replica count.

Run: ``python -m mint_tpu_torch.serving.server --config_path=<config>
[--checkpoint_dir=<train model_dir>]``.
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from mint_tpu_torch.infer import decoder
from mint_tpu_torch.models.fact import FACT
from mint_tpu_torch.parallel.replicas import Replicas, devices_for

log = logging.getLogger(__name__)


class _Request:
    def __init__(self, audio: np.ndarray, seed: Optional[np.ndarray],
                 steps: int):
        self.audio = audio
        self.seed = seed
        self.steps = steps
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[str] = None
        # True when `error` is a service fault (worker death): generate()
        # raises RuntimeError (HTTP 500), not ValueError (400).
        self.fatal = False
        # Padded batch size of the dispatch this request rode in (0 =
        # never dispatched); warmup reads it to verify its burst co-batched.
        self.cobatch = 0


class GenerationService:
    """Owns the model (and its weights) and the batching worker."""

    def __init__(self, model: FACT, batch_window_ms: float = 10.0,
                 max_batch: int = 8, default_steps: int = 1200,
                 steps_bucket: int = 128, request_timeout: float = 900.0,
                 devices=None):
        """`steps_bucket` quantizes generation lengths upward so requests
        of nearby lengths share one decode; extra frames read zero audio
        padding and are trimmed before returning (exact: frame i only
        reads audio [i, i + window), real for i < requested steps).
        `devices` (default: the model's alone; the model's first) hold a
        replica each, every decode's rows split over them; each replica's
        rows are built on its device."""
        self.model = model
        self.device = model.device
        self.replicas = Replicas(model, devices or [model.device])
        self.batch_window = batch_window_ms / 1000.0
        self.max_batch = max_batch
        self.default_steps = default_steps
        self.steps_bucket = max(1, steps_bucket)
        self.request_timeout = request_timeout
        self.motion_dim = model.cross_modal_layer.cross_output_layer \
            .out_features
        self.audio_dim = model.audio_dim
        # decode_steps: sum over dispatches of the decode loop's length.
        self.stats = {"requests": 0, "batches": 0, "generated_frames": 0,
                      "decode_steps": 0}
        self._stats_lock = threading.Lock()
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._fatal: Optional[str] = None
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _bump(self, key: str, amount: int = 1) -> None:
        with self._stats_lock:  # += is not atomic across handler threads
            self.stats[key] += amount

    def stats_snapshot(self) -> dict:
        """Mutually-consistent copy of the counters (taken under the lock)."""
        with self._stats_lock:
            return dict(self.stats, replicas=len(self.replicas))

    # -- client side -----------------------------------------------------

    def generate(self, audio: np.ndarray, seed: Optional[np.ndarray] = None,
                 steps: Optional[int] = None,
                 timeout: Optional[float] = None) -> np.ndarray:
        """Generate motion for one clip; blocks until its batch is done.
        Shapes are validated here so one bad request cannot fail the
        bucket it would have been co-batched with."""
        if timeout is None:
            timeout = self.request_timeout
        motion_seq = self.model.motion_seq_length
        audio = np.asarray(audio, np.float32)
        if audio.ndim != 2 or audio.shape[1] != self.audio_dim:
            raise ValueError(
                f"audio features must be [T, {self.audio_dim}], got "
                f"{list(audio.shape)}")
        if seed is not None:
            seed = np.asarray(seed, np.float32)
            if seed.shape != (motion_seq, self.motion_dim):
                raise ValueError(
                    f"seed motion must be [{motion_seq}, "
                    f"{self.motion_dim}], got {list(seed.shape)}")
        if self._fatal:
            raise RuntimeError(self._fatal)
        req = _Request(audio, seed, steps or self.default_steps)
        self._bump("requests")
        self._q.put(req)
        # Poll in short slices so a dead worker surfaces now, not as a
        # silent hang; the monotonic deadline keeps the timeout strict.
        deadline = (None if timeout == float("inf")
                    else time.monotonic() + timeout)
        while True:
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                if req.event.is_set():
                    break
                raise TimeoutError("generation timed out")
            if req.event.wait(1.0 if remaining is None
                              else min(1.0, remaining)):
                break
            if self._fatal and not req.event.is_set():
                raise RuntimeError(self._fatal)
        if req.error:
            raise (RuntimeError if req.fatal else ValueError)(req.error)
        return req.result

    def warmup(self, steps: Optional[int] = None, batch: int = 1,
               all_buckets: bool = False) -> float:
        """Run throwaway generations through the worker so one-time first
        dispatch costs (the kernels' build, CUDA context and allocator
        warm-up, and on the card the capture of each warmed bucket's decode
        graph) are paid at boot: a later request of a warmed bucket
        captures nothing.  `batch` > 1 enqueues that many
        requests at once so they co-batch (clamped to `max_batch`);
        `all_buckets` warms every pow2 batch bucket from 2 up through
        `batch`'s.  Returns the wall seconds spent."""
        t0 = time.time()
        n = steps or self.default_steps
        audio_len = n + self.model.audio_seq_length - 1
        audio = np.zeros((audio_len, self.audio_dim), np.float32)
        batch = max(1, min(int(batch), self.max_batch))
        if batch == 1:
            if all_buckets:
                log.warning(
                    "warmup(all_buckets=True) with batch=1 warms only "
                    "the batch-1 bucket; pass batch=%d to warm every "
                    "bucket", self.max_batch)
            self.generate(audio, steps=n, timeout=float("inf"))
            return self._warmed(t0)
        if all_buckets:
            # One warm per distinct padded bucket <= batch's; the smallest
            # request count that pads to each.
            targets: Dict[int, int] = {}
            for k in range(2, batch + 1):
                targets.setdefault(self._padded(k), k)
            sizes = [targets[b] for b in sorted(targets)]
        else:
            sizes = [batch]
        for n_req in sizes:
            self._warm_cobatch(audio, n, n_req)
        return self._warmed(t0)

    def _padded(self, n_real: int) -> int:
        """The padded batch a dispatch of `n_real` requests decodes."""
        return decoder.padded_batch_size(n_real, data=len(self.replicas))

    def _warmed(self, t0: float) -> float:
        seconds = time.time() - t0
        log.info("warmup done in %.1f s; the replicas' decode graphs: %s",
                 seconds, self.replicas.summary())
        return seconds

    def _warm_cobatch(self, audio: np.ndarray, n_steps: int,
                      n_req: int, attempts: int = 3) -> None:
        """Enqueue `n_req` throwaway requests at once so the worker
        co-batches them into ONE dispatch, and verify it did: every warm
        request must report the target padded batch size
        (`_Request.cobatch`).  A split burst is retried; if every attempt
        misses, a warning names the bucket that may still be cold."""
        if self._fatal:
            raise RuntimeError(self._fatal)
        target = self._padded(n_req)
        for attempt in range(attempts):
            reqs = [_Request(audio, None, n_steps) for _ in range(n_req)]
            for req in reqs:
                self._bump("requests")
                self._q.put(req)
            for req in reqs:
                while not req.event.wait(1.0):
                    if self._fatal:
                        raise RuntimeError(self._fatal)
                if req.error:
                    raise (RuntimeError if req.fatal else ValueError)(
                        req.error)
            rode = sorted({req.cobatch for req in reqs})
            if rode == [target]:
                return
            if attempt + 1 < attempts:
                log.warning(
                    "warmup burst of %d split into bucket(s) %s instead "
                    "of one bucket-%d dispatch (batching window expired "
                    "mid-burst, or live traffic rode along); retrying "
                    "(%d/%d)", n_req, rode, target, attempt + 2, attempts)
        log.warning(
            "warmup for a %d-request burst never co-batched after %d "
            "attempts — the batch-%d bucket may still be cold for the "
            "first real concurrent burst", n_req, attempts, target)

    def close(self):
        self._stop.set()
        self._q.put(None)  # wake the worker

    # -- worker ----------------------------------------------------------

    def _collect(self) -> List[_Request]:
        item = self._q.get()
        if item is None:
            return []
        batch = [item]
        deadline = time.monotonic() + self.batch_window
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                # Keep the shutdown sentinel for the next _collect call.
                self._q.put(None)
                break
            batch.append(nxt)
        return batch

    def _run(self):
        batch: List[_Request] = []
        try:
            while not self._stop.is_set():
                batch = self._collect()
                if not batch:
                    continue
                self._process(batch)
                batch = []
        except BaseException as e:
            # Anything outside the per-bucket try would kill this thread
            # silently and strand every waiter: record the death and fail
            # the in-flight batch and the queue.
            self._fatal = f"serving worker died: {type(e).__name__}: {e}"
            log.exception("serving worker died")
            pending = [r for r in batch if not r.event.is_set()]
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    pending.append(item)
            for req in pending:
                req.error = self._fatal
                req.fatal = True
                req.event.set()

    def _process(self, batch: List[_Request]):
        motion_seq = self.model.motion_seq_length
        buckets: Dict[int, List[_Request]] = {}
        for req in batch:
            n = decoder.max_steps(self.model, req.audio.shape[0], req.steps)
            if n <= 0:
                req.error = (f"audio too short: {req.audio.shape[0]} "
                             f"frames < {self.model.audio_seq_length}")
                req.event.set()
                continue
            buckets.setdefault(decoder.quantize_steps(n, self.steps_bucket),
                               []).append(req)

        for n_steps, reqs in sorted(buckets.items()):
            # A failure (OOM, ...) fails only THIS bucket's requests.
            try:
                audio_len = n_steps + self.model.audio_seq_length - 1
                n_real = len(reqs)
                batch = self._padded(n_real)
                seeds = [r.seed if r.seed is not None
                         else np.zeros((motion_seq, self.motion_dim),
                                       np.float32) for r in reqs]
                seeds += [seeds[-1]] * (batch - n_real)
                audio_rows = []
                for r in reqs:
                    row = np.zeros((audio_len, r.audio.shape[1]),
                                   np.float32)
                    row[:min(audio_len, len(r.audio))] = r.audio[:audio_len]
                    audio_rows.append(row)
                audio_rows += [audio_rows[-1]] * (batch - n_real)
                out = self.replicas.decode(
                    {"motion_input": np.stack(seeds),
                     "audio_input": np.stack(audio_rows)}, steps=n_steps)
                self._bump("batches")
                self._bump("decode_steps", n_steps)
                for i, req in enumerate(reqs):
                    req_steps = decoder.max_steps(
                        self.model, req.audio.shape[0], req.steps)
                    req.result = out[i, :req_steps]
                    req.cobatch = batch
                    self._bump("generated_frames", int(req_steps))
                    req.event.set()
            except Exception as e:
                log.exception("decode of a %d-step bucket failed", n_steps)
                for req in reqs:
                    if not req.event.is_set():
                        req.error = str(e)
                        req.event.set()


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _make_handler(service: GenerationService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                info = {
                    "status": "ok",
                    "motion_seq": service.model.motion_seq_length,
                    "audio_seq": service.model.audio_seq_length,
                    "motion_dim": service.motion_dim,
                    "device": str(service.device),
                }
                self._send(200, json.dumps(info).encode(),
                           "application/json")
            elif path == "/stats":
                self._send(200, json.dumps(service.stats_snapshot()).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path != "/generate":
                self._send(404, b"not found", "text/plain")
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                arrays = _load_npy_stream(self.rfile.read(length))
                audio = arrays[0]
                seed = arrays[1] if len(arrays) > 1 else None
                qs = parse_qs(parsed.query)
                steps = int(qs.get("steps", [service.default_steps])[0])
                out = service.generate(audio, seed=seed, steps=steps)
                self._send(200, _npy_bytes(out))
            except (ValueError, IndexError) as e:
                self._send(400, json.dumps(
                    {"error": str(e)}).encode(), "application/json")
            except TimeoutError as e:
                self._send(504, json.dumps(
                    {"error": str(e)}).encode(), "application/json")
            except Exception as e:  # never drop the connection silently
                self._send(500, json.dumps(
                    {"error": f"internal error: {e}"}).encode(),
                    "application/json")

    return Handler


def _load_npy_stream(body: bytes) -> List[np.ndarray]:
    """One or more concatenated .npy blobs -> arrays (no pickles)."""
    arrays = []
    buf = io.BytesIO(body)
    while buf.tell() < len(body):
        arrays.append(np.load(buf, allow_pickle=False))
    return arrays


def serve(service: GenerationService, host: str = "127.0.0.1",
          port: int = 8490) -> ThreadingHTTPServer:
    """Start the HTTP server (returns it; call .shutdown() to stop)."""
    server = ThreadingHTTPServer((host, port), _make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Batched FACT dance-generation server (PyTorch port). "
        "Weights come from --checkpoint_dir, else from the port's "
        "initialization, seeded 0.")
    p.add_argument("--config_path", required=True, help="Pipeline config.")
    p.add_argument("--checkpoint_dir", default=None,
                   help="Checkpoint directory in the port's format (the "
                   "train CLI's model_dir): its latest step's parameters "
                   "are served.")
    p.add_argument("--host", default="0.0.0.0", help="Bind host.")
    p.add_argument("--port", type=int, default=8490, help="Bind port.")
    p.add_argument("--steps", type=int, default=1200,
                   help="Default generation length.")
    p.add_argument("--request_timeout", type=float, default=900.0,
                   help="Per-request generation timeout in seconds.")
    p.add_argument("--warmup", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="Run one throwaway generation at boot so the first "
                   "client does not pay the kernels' build.")
    p.add_argument("--warmup_batch", type=int, default=1,
                   help="Also warm the batch-N bucket with N co-batched "
                   "throwaway requests.")
    p.add_argument("--warmup_all_buckets", action="store_true",
                   help="Warm every pow2 batch bucket from 2 up through "
                   "--warmup_batch's (--max_batch's if unset).")
    p.add_argument("--use_bfloat16", action="store_true",
                   help="Serve with bf16 compute; default f32, the "
                   "reference's eval/scoring semantics.")
    p.add_argument("--batch_window_ms", type=float, default=10.0,
                   help="How long the batcher holds the first queued "
                   "request for same-bucket companions.")
    p.add_argument("--max_batch", type=int, default=8,
                   help="Close a batch early at this many requests.")
    p.add_argument("--device", default="cuda",
                   help="Torch device to serve on.")
    p.add_argument("--data_parallelism", type=int, default=0,
                   help="Decode over this many replicas, one a card (0 = "
                   "every card; 1 = one card); on the CPU, replicas on the "
                   "CPU (0 = 1).")
    return p


def load_model(args: argparse.Namespace) -> FACT:
    """The model the CLI serves: built from ``--config_path`` on
    ``--device`` in f32 or bf16, holding the parameters of the latest
    checkpoint in ``--checkpoint_dir`` (a params-only restore: the Adam
    state, two thirds of a checkpoint, is never read) or, without one, the
    port's initialization seeded 0."""
    from mint_tpu_torch.config.schema import load_pipeline_config
    from mint_tpu_torch.models import builder
    from mint_tpu_torch.models.fact import init_params
    from mint_tpu_torch.train.checkpoint import CheckpointManager

    pipeline = load_pipeline_config(args.config_path)
    model = builder.build(
        pipeline.multi_modal_model, is_training=False,
        dtype=torch.bfloat16 if args.use_bfloat16 else torch.float32,
        device=args.device)
    if args.checkpoint_dir:
        model.load_state_dict(CheckpointManager(
            args.checkpoint_dir).restore_params(model.state_dict()))
    else:
        init_params(model, torch.Generator().manual_seed(0))
    return model


def main(argv=None):
    args = _parser().parse_args(argv)
    # f32 serving is the reference's scoring semantics: no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = load_model(args)
    service = GenerationService(model, batch_window_ms=args.batch_window_ms,
                                max_batch=args.max_batch,
                                default_steps=args.steps,
                                request_timeout=args.request_timeout,
                                devices=devices_for(model.device,
                                                    args.data_parallelism))
    if args.warmup:
        print("warming up the default steps bucket...", flush=True)
        print(f"warmup done in {service.warmup():.1f} s", flush=True)
        warm_batch = args.warmup_batch
        if args.warmup_all_buckets and warm_batch <= 1:
            warm_batch = args.max_batch
        if warm_batch > 1:
            dt = service.warmup(batch=warm_batch,
                                all_buckets=args.warmup_all_buckets)
            print(f"batch warmup done in {dt:.1f} s", flush=True)
    server = serve(service, args.host, args.port)
    print(f"serving on {args.host}:{args.port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()
        service.close()


if __name__ == "__main__":
    main()
