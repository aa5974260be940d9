"""HTTP serving with request micro-batching: `python -m sd_tpu_torch.serve`.

Counterpart of `sd_tpu/serve.py` and `scripts/serve.py`: a long-lived
process that owns one `Text2ImagePipeline` on the card and turns concurrent
HTTP requests into batched `generate` calls. The batcher groups requests
by everything that changes the sampled batch (steps, sampler, guidance,
rescale, eta, size, explicit seed, clip_skip, sag_scale), collects up to
`max_batch` prompts inside a `batch_window_ms` window, pads the group to a
power-of-two bucket and runs it as one `generate`; an error reaches every
waiter of the group and the server keeps serving.

Endpoints (JSON over HTTP; stdlib http.server):
  POST /generate  {"prompt": str, "negative_prompt"?, "steps"?,
                   "guidance_scale"?, "sampler"?, "seed"?, "width"?,
                   "height"?, "guidance_rescale"?, "eta"?, "clip_skip"?,
                   "sag_scale"?}
                  → {"image": <base64 PNG>, "batch_size": n, "seed": s}
  GET  /healthz   → {"ok": true, "queue_depth": d, "requests_served": n,
                     "batches_run": m}

A request carrying "seed" is reproducible: the seed joins the batching key.
Requests without one are assigned one and report it back. PNGs are written
by `data/image_io.py` (zlib and struct, no imaging package).

    python -m sd_tpu_torch.serve --config sd_v1 --port 8000 --max-batch 4
    curl -s localhost:8000/generate -d '{"prompt": "a photo of a cat",
        "steps": 30, "sampler": "dpm"}' | jq -r .image | base64 -d > cat.png

`--config` takes a config function's name or a .json / .yaml file
(`core/config.py load_config`); `--sd-checkpoint FILE` serves an SD-v1
`.ckpt` or `.safetensors` (`Text2ImagePipeline.from_sd_checkpoint`), `--run
DIR` a `train_ldm` run (`Text2ImagePipeline.from_run`: its EMA UNet, the
config's trained first stage, its calibrated scale factor), else the weights
are random from the config's seed. `--lora FILE` merges a `.safetensors` LoRA
(`load_lora`), `--tome` and `--freeu` set the UNet's serving options
(`set_unet_options`). `--shard` serves over every rank of the process group
(`Text2ImagePipeline.shard_for_serving`; under torchrun, `--mesh data=2,model=2`
for a tensor-parallel UNet, default every rank on "data"): rank 0 owns the HTTP
server and the batcher, and each grouped batch's prompts and parameters are
broadcast to the other ranks, which run the same `generate` (`ShardedGenerate`;
a group is padded to a multiple of the data axis). A `generate` that fails on
any rank tears the group down: that rank exits non-zero, and the others'
collectives fail rather than wait. Without torchrun `--shard` runs the same
path over a process group of one rank.

    torchrun --nproc-per-node 2 -m sd_tpu_torch.serve --config sd_v1 --shard \
        --mesh data=1,model=2

    python -m sd_tpu_torch.serve --config runs/ldm/config.json --run runs/ldm

A consistency-distilled student (`python -m sd_tpu_torch.train` with `task:
distill`) serves its `--run` with `--sampler lcm` (requests at 2–4 steps,
"guidance_scale": 1.0); a flow model (`diffusion.type: flow`) with
`--sampler flow` or `flow_midpoint`:

    python -m sd_tpu_torch.serve --config runs/lcm/config.json --run runs/lcm \
        --sampler lcm --steps 4
    python -m sd_tpu_torch.serve --config sd_v1 --sd-checkpoint v1-5.safetensors \
        --lora style.safetensors --tome 0.5 --freeu 1.2,1.4,0.9,0.2
"""

from __future__ import annotations

import argparse
import base64
import json
import queue
import sys
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

from sd_tpu_torch.data.image_io import decode_png, encode_png  # noqa: F401 (re-exported)

ALLOWED_SAMPLERS = ("ddim", "dpm", "dpm_sde", "unipc", "plms", "euler",
                    "euler_a", "heun", "ddpm",
                    # a consistency-distilled student (lcm, guidance_scale 1)
                    # and a flow model (flow, flow_midpoint); the model-family
                    # guards in LatentDiffusion.sample answer a mismatched
                    # request with a ValueError
                    "lcm", "flow", "flow_midpoint")

def _png_b64(img: np.ndarray) -> str:
    return base64.b64encode(encode_png(img)).decode("ascii")


@dataclass
class _Request:
    prompt: str
    negative_prompt: str
    key: tuple          # batching/compilation key (see _make_key)
    kwargs: dict        # generate() kwargs shared by everyone with this key
    event: threading.Event = field(default_factory=threading.Event)
    image: np.ndarray | None = None
    error: str | None = None
    batch_size: int = 0


def _make_key(params: dict, explicit_seed: bool) -> tuple:
    """Everything that changes the compiled program or the sampled batch
    must be in the key; prompt/negative_prompt are per-slot payload.
    Auto-seeded requests key their seed as None so they batch freely (the
    group adopts its first member's seed and reports it back); an explicit
    seed joins the key for reproducibility."""
    return (
        int(params["steps"]),
        str(params["sampler"]),
        float(params["guidance_scale"]),
        float(params["guidance_rescale"]),
        float(params["eta"]),
        params["height"],
        params["width"],
        int(params["seed"]) if explicit_seed else None,
        params["clip_skip"],
        float(params.get("sag_scale", 0.0)),
    )


class BatchingServer:
    """Micro-batching front-end around a Text2ImagePipeline-like object.

    `pipeline` only needs a `.generate(prompts, negative_prompt=..., ...)
    -> uint8 [B, H, W, 3]` method, which keeps the batcher unit-testable
    with a stub.
    """

    def __init__(
        self,
        pipeline: Any,
        max_batch: int = 4,
        batch_window_ms: float = 50.0,
        default_steps: int = 30,
        default_sampler: str = "ddim",
        default_guidance: float = 7.5,
        queue_limit: int = 64,
        request_timeout_s: float = 600.0,
        watermark: str | None = None,
    ):
        self.pipeline = pipeline
        # server-wide provenance mark (utils/watermark.py) on every image
        self.watermark = watermark
        self.max_batch = int(max_batch)
        self.batch_window_s = float(batch_window_ms) / 1e3
        self.default_steps = int(default_steps)
        self.default_sampler = default_sampler
        self.default_guidance = float(default_guidance)
        self.request_timeout_s = float(request_timeout_s)
        self._queue: queue.Queue[_Request] = queue.Queue(maxsize=queue_limit)
        self._stop = threading.Event()
        self._worker: threading.Thread | None = None
        self._seed_lock = threading.Lock()
        self._auto_seed = int(time.time()) & 0x7FFFFFFF
        self.batches_run = 0
        self.requests_served = 0

    # ------------------------------------------------------------- public --

    def start(self) -> None:
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def stop(self) -> None:
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=5)

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def submit(self, body: dict) -> dict:
        """Validate one request body, enqueue it, wait for its image."""
        req = self._validate(body)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise RuntimeError("server overloaded: queue full")
        if not req.event.wait(self.request_timeout_s):
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise RuntimeError(req.error)
        return {
            "image": _png_b64(req.image),
            "batch_size": req.batch_size,
            "seed": req.kwargs["seed"],
        }

    # ----------------------------------------------------------- internal --

    def _validate(self, body: dict) -> _Request:
        if not isinstance(body, dict) or "prompt" not in body:
            raise ValueError('body must be a JSON object with "prompt"')
        prompt = body["prompt"]
        if not isinstance(prompt, str) or not prompt.strip():
            raise ValueError('"prompt" must be a non-empty string')
        sampler = body.get("sampler", self.default_sampler)
        if sampler not in ALLOWED_SAMPLERS:
            raise ValueError(f'unknown sampler {sampler!r}; '
                             f'one of {ALLOWED_SAMPLERS}')
        steps = int(body.get("steps", self.default_steps))
        if not 1 <= steps <= 1000:
            raise ValueError("steps must be in [1, 1000]")
        if "seed" in body:
            seed = int(body["seed"])
        else:
            with self._seed_lock:
                self._auto_seed = (self._auto_seed * 6364136223846793005
                                   + 1442695040888963407) & 0x7FFFFFFF
                seed = self._auto_seed
        for dim in ("width", "height"):
            if body.get(dim) is not None and int(body[dim]) % 8 != 0:
                raise ValueError(f"{dim} must be a multiple of 8")
        params = {
            "steps": steps,
            "sampler": sampler,
            "guidance_scale": float(body.get("guidance_scale",
                                             self.default_guidance)),
            "guidance_rescale": float(body.get("guidance_rescale", 0.0)),
            "eta": float(body.get("eta", 0.0)),
            "height": int(body["height"]) if body.get("height") else None,
            "width": int(body["width"]) if body.get("width") else None,
            "seed": seed,
            "clip_skip": int(body["clip_skip"]) if body.get("clip_skip")
                         else None,
            "sag_scale": float(body.get("sag_scale", 0.0)),
        }
        if params["sag_scale"] > 0.0 and sampler != "ddim":
            raise ValueError("sag_scale requires the ddim sampler")
        return _Request(
            prompt=prompt,
            negative_prompt=str(body.get("negative_prompt", "")),
            key=_make_key(params, explicit_seed="seed" in body),
            kwargs=params,
        )

    def _drain_group(self, first: _Request) -> list[_Request]:
        """Collect up to max_batch same-key requests within the window.
        Different-key requests seen while draining go back to the queue."""
        group = [first]
        putback: list[_Request] = []
        deadline = time.monotonic() + self.batch_window_s
        while len(group) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt.key == first.key:
                group.append(nxt)
            else:
                putback.append(nxt)
        for r in putback:
            self._queue.put(r)
        return group

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            group = self._drain_group(first)
            params = dict(group[0].kwargs)
            for r in group:  # the whole group ran under this seed
                r.kwargs["seed"] = params["seed"]
            prompts = [r.prompt for r in group]
            negatives = [r.negative_prompt for r in group]
            # pad to the next power-of-two bucket (the pad slots repeat the
            # last prompt and are dropped below), so a group of 3 runs the
            # same batch-4 work as a group of 4: the set of batch shapes the
            # card sees stays log2(max_batch) + 1
            bucket = 1
            while bucket < len(group):
                bucket *= 2
            for _ in range(bucket - len(group)):
                prompts.append(prompts[-1])
                negatives.append(negatives[-1])
            try:
                imgs = self.pipeline.generate(
                    prompts,
                    negative_prompt=negatives,
                    num_steps=params["steps"],
                    guidance_scale=params["guidance_scale"],
                    guidance_rescale=params["guidance_rescale"],
                    sampler=params["sampler"],
                    seed=params["seed"],
                    height=params["height"],
                    width=params["width"],
                    clip_skip=params["clip_skip"],
                    **({"eta": params["eta"]}
                       if params["sampler"] == "ddim" else {}),
                    **({"sag_scale": params["sag_scale"]}
                       if params.get("sag_scale", 0.0) > 0.0 else {}),
                    **({"watermark": self.watermark}
                       if self.watermark else {}),
                )
                for i, r in enumerate(group):
                    r.image = np.asarray(imgs[i])
                    r.batch_size = len(group)
            except Exception as e:  # surface to every waiter, keep serving
                for r in group:
                    r.error = f"{type(e).__name__}: {e}"
            self.batches_run += 1
            self.requests_served += len(group)
            for r in group:
                r.event.set()


def make_http_server(batcher: BatchingServer, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    """Bind the batcher to a threaded stdlib HTTP server (port 0 = ephemeral;
    the bound port is `server.server_address[1]`). The caller runs
    `server.serve_forever()` (or in a thread) and `batcher.start()`."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet: metrics live on the batcher
            pass

        def _reply(self, code: int, payload: dict) -> None:
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True,
                                  "queue_depth": batcher.queue_depth(),
                                  "requests_served": batcher.requests_served,
                                  "batches_run": batcher.batches_run})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError):
                self._reply(400, {"error": "invalid JSON body"})
                return
            try:
                self._reply(200, batcher.submit(body))
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except TimeoutError as e:
                self._reply(504, {"error": str(e)})
            except RuntimeError as e:
                code = 503 if "overloaded" in str(e) else 500
                self._reply(code, {"error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m sd_tpu_torch.serve",
                                 description="Serve text-to-image over HTTP with "
                                             "request micro-batching, on the GPU.")
    ap.add_argument("--config", required=True,
                    help="a configuration: a config function's name (sd_v1: "
                         "sd_v1_config()) or a .json / .yaml file")
    ap.add_argument("--run", default=None,
                    help="a train_ldm run directory (ckpt/ + calibration.json); "
                         "omit for random weights")
    ap.add_argument("--sd-checkpoint", default=None,
                    help="an SD-v1 .ckpt or .safetensors to import instead of --run")
    ap.add_argument("--lora", default=None,
                    help="a LoRA file (.safetensors) to merge for serving")
    ap.add_argument("--device", default=None, help="cpu to serve from the CPU")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--batch-window-ms", type=float, default=50.0)
    ap.add_argument("--steps", type=int, default=30,
                    help="default steps when a request omits them")
    ap.add_argument("--sampler", default="ddim", choices=ALLOWED_SAMPLERS,
                    help="default sampler when a request omits one")
    ap.add_argument("--watermark", default=None,
                    help="invisible provenance mark on every output "
                         "(sd_tpu_torch.utils.watermark.verify_watermark checks it)")
    ap.add_argument("--shard", action="store_true",
                    help="serve over every rank of the process group (torchrun; one rank "
                         "without it)")
    ap.add_argument("--mesh", default=None,
                    help='the ranks\' axes under --shard, e.g. "data=2,model=2" (default: '
                         'every rank on data)')
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the process group's backend under --shard (default nccl on the "
                         "card, gloo on the CPU)")
    ap.add_argument("--tome", type=float, default=0.0,
                    help="ToMe token-merge ratio (0 = off; ~0.5 typical)")
    ap.add_argument("--freeu", default=None,
                    help='FreeU "b1,b2,s1,s2" (e.g. "1.2,1.4,0.9,0.2")')
    return ap.parse_args(argv)


def build_pipeline(args: argparse.Namespace):
    """The pipeline the flags ask for, as `scripts/serve.py` builds it:
    `--sd-checkpoint`, else `--run`, else random weights; then `--lora`,
    `--tome`, `--freeu`."""
    from sd_tpu_torch.core.config import load_config
    from sd_tpu_torch.pipeline import Text2ImagePipeline

    cfg = load_config(args.config)
    if args.sd_checkpoint:
        pipe = Text2ImagePipeline.from_sd_checkpoint(cfg, args.sd_checkpoint,
                                                     device=args.device)
    elif args.run:
        pipe = Text2ImagePipeline.from_run(cfg, args.run, device=args.device)
    else:
        pipe = Text2ImagePipeline(cfg, device=args.device)
    if args.lora:
        pipe.load_lora(args.lora)
    opts = {}
    if args.tome > 0:
        opts["tome_ratio"] = args.tome
    if args.freeu:
        opts["freeu"] = tuple(float(v) for v in args.freeu.split(","))
    if opts:
        pipe.set_unet_options(**opts)
    return pipe


class ShardedGenerate:
    """Rank 0's view of a pipeline served over a process group: `generate`
    broadcasts its arguments to the other ranks (`follow`), pads the prompts
    to a multiple of the data axis and runs the pipeline's `generate`, as
    every other rank does with the same arguments. The requests were
    validated before they were grouped, so a failure here is a fault of the
    group: it tears the group down (the other ranks' collectives fail and
    they exit) and every later call raises."""

    def __init__(self, pipeline: Any):
        self.pipeline = pipeline
        self.failed: str | None = None

    def generate(self, prompts, **kw):
        if self.failed:
            raise RuntimeError(f"the process group was torn down after {self.failed}: "
                               "restart the server")
        try:
            return self._generate(prompts, **kw)
        except Exception as e:
            self.failed = f"{type(e).__name__}: {e}"
            _teardown()
            raise

    def _generate(self, prompts, **kw):
        n = len(prompts)
        data = self.pipeline.mesh.size("data")
        pad = -n % data
        prompts = list(prompts) + [prompts[-1]] * pad
        neg = kw.get("negative_prompt", "")
        if not isinstance(neg, str):
            kw["negative_prompt"] = list(neg) + [neg[-1]] * pad
        _broadcast({"prompts": prompts, "kw": kw})
        return self.pipeline.generate(prompts, **kw)[:n]

    def stop(self) -> None:
        if not self.failed:
            _broadcast(None)


def _broadcast(payload):
    import torch.distributed as dist

    box = [payload]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _teardown() -> None:
    """End this rank's part in the process group (its peers' pending and
    later collectives then fail instead of waiting)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def follow(pipeline: Any) -> int:
    """A rank other than 0 under `--shard`: run every `generate` rank 0
    broadcasts until it broadcasts None. A failure tears the group down and
    raises, so the process exits non-zero and rank 0's collective fails
    rather than waiting for this rank."""
    served = 0
    while True:
        payload = _broadcast(None)
        if payload is None:
            return served
        try:
            pipeline.generate(payload["prompts"], **payload["kw"])
        except Exception as e:
            print(f"[shard] generate failed on this rank: {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)
            _teardown()
            raise
        served += 1


def parse_mesh(text: str | None) -> dict[str, int] | None:
    """"data=2,model=2" → {"data": 2, "model": 2}."""
    if not text:
        return None
    return {k.strip(): int(v) for k, v in (part.split("=") for part in text.split(","))}


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    if not args.shard:
        return _serve(args, build_pipeline(args))
    import socket

    import torch.distributed as dist

    from sd_tpu_torch.parallel import mesh as pmesh
    from sd_tpu_torch.parallel import multihost

    if not multihost.initialize(backend=args.backend, device=args.device):
        with socket.socket() as s:     # one rank: a process group of its own
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        multihost.initialize(backend=args.backend, device=args.device, rank=0, world_size=1,
                             init_method=f"tcp://127.0.0.1:{port}")
    try:
        if args.device is None:
            args.device = multihost.local_device()
        mesh = pmesh.make_mesh(parse_mesh(args.mesh))     # before anything is built
        pipe = build_pipeline(args)
        pipe.shard_for_serving(mesh)
        rank, world = multihost.rank_and_world()
        print(f"[shard] rank {rank}/{world} mesh={pipe.mesh.axes()} ({dist.get_backend()})",
              flush=True)
        if rank != 0:
            follow(pipe)
            return 0
        sharded = ShardedGenerate(pipe)
        try:
            return _serve(args, sharded)
        finally:
            sharded.stop()
    finally:
        _teardown()


def _serve(args: argparse.Namespace, pipe) -> int:
    batcher = BatchingServer(pipe, max_batch=args.max_batch,
                             batch_window_ms=args.batch_window_ms,
                             default_steps=args.steps, default_sampler=args.sampler,
                             watermark=args.watermark)
    batcher.start()
    server = make_http_server(batcher, host=args.host, port=args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(max_batch={args.max_batch}, window={args.batch_window_ms}ms)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        batcher.stop()
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
