"""Measure the serving daemon: requests/s, p50 / p99 latency, and how much
micro-batching buys.

    python -m sd_tpu_torch.bench_serve --config sd_v1 --clients 8 --requests 3 \\
        --out bench_serve.json

Counterpart of `scripts/bench_serve.py`: `serve.BatchingServer` behind its
HTTP front end (`make_http_server`) in this process, driven over loopback by
concurrent client threads, at the SD-v1 512² text-to-image geometry on the
card (`--device` names another). Rows, each a serving regime:
  ddim50  50-step DDIM + CFG 7.5   the quality regime
  lcm4    4-step LCM, no CFG       the few-step regime (guidance 1.0)
  dpm15   15-step DPM-Solver++ + CFG 7.5
For each row: a warm-up group at every power-of-two bucket up to
`--max-batch` (untimed), a sequential single client (3 requests: the
latency at batch 1), then `--clients` threads × `--requests` each. The
batching speedup is the concurrent img/s over the sequential img/s; the
batcher's `requests_served` / `batches_run` over the concurrent phase give
the realized mean batch. `--smoke` runs the tiny `sd_txt2img_smoke` model,
each row cut to 3 steps. Weights are random from a seed (no pretrained
weights are in the repository): throughput does not depend on them. Writes
nothing but `--out`.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.request

PROMPTS = ["a photo of a cat", "a photo of a dog", "a watercolor cat",
           "a studio portrait of a dog", "a cat on a sofa", "a dog in snow",
           "an oil painting of a cat", "a sketch of a dog"]

ROWS = {
    "ddim50": {"steps": 50, "sampler": "ddim", "guidance_scale": 7.5},
    # an LCM student has its guidance baked in at distillation: the request
    # carries no CFG branch
    "lcm4": {"steps": 4, "sampler": "lcm", "guidance_scale": 1.0},
    "dpm15": {"steps": 15, "sampler": "dpm", "guidance_scale": 7.5},
}


def _post(port: int, body: dict, timeout: float = 900.0) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _percentile(xs: list[float], p: float) -> float:
    xs = sorted(xs)
    k = (len(xs) - 1) * p
    lo, hi = int(k), min(int(k) + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def _together(n: int, fn) -> None:
    """fn(i) for i < n in n threads released together."""
    barrier = threading.Barrier(n)

    def run(i):
        barrier.wait()
        fn(i)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def run_row(name: str, port: int, batcher, body: dict, clients: int,
            requests_per_client: int) -> dict:
    """One row: the warm-up group at every power-of-two bucket, 3 sequential
    requests, then `clients` concurrent clients of `requests_per_client`
    requests each; its figures as a dict."""
    # one group per bucket the phases can reach (a full group, and the 2- and
    # 3-request tails of a short queue), so that no first call is timed
    t0 = time.perf_counter()
    nb = 1
    while True:
        if nb == 1:
            _post(port, {**body, "prompt": PROMPTS[0]})
        else:
            _together(nb, lambda i: _post(port, {**body, "prompt": PROMPTS[i % len(PROMPTS)]}))
        if nb >= batcher.max_batch:
            break
        nb = min(nb * 2, batcher.max_batch)
    compile_s = time.perf_counter() - t0

    seq_lat = []
    for i in range(3):
        t = time.perf_counter()
        _post(port, {**body, "prompt": PROMPTS[i % len(PROMPTS)]})
        seq_lat.append(time.perf_counter() - t)
    seq_ips = 1.0 / (sum(seq_lat) / len(seq_lat))

    batcher.requests_served = 0
    batcher.batches_run = 0
    lat: list[float] = []
    lat_lock = threading.Lock()
    start = threading.Barrier(clients + 1)

    def client(ci: int):
        start.wait()
        for ri in range(requests_per_client):
            t = time.perf_counter()
            _post(port, {**body, "prompt": PROMPTS[(ci + ri) % len(PROMPTS)]})
            dt = time.perf_counter() - t
            with lat_lock:
                lat.append(dt)

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(clients)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    n = clients * requests_per_client
    mean_batch = (batcher.requests_served / batcher.batches_run
                  if batcher.batches_run else 0.0)
    return {
        "row": name,
        "steps": body["steps"],
        "sampler": body["sampler"],
        "guidance_scale": body["guidance_scale"],
        "clients": clients,
        "requests": n,
        "wall_s": round(wall, 3),
        "requests_per_s": round(n / wall, 4),
        "img_per_s": round(n / wall, 4),          # one image a request
        "p50_s": round(_percentile(lat, 0.50), 3),
        "p99_s": round(_percentile(lat, 0.99), 3),
        "seq_latency_s": round(sum(seq_lat) / len(seq_lat), 3),
        "seq_img_per_s": round(seq_ips, 4),
        "batching_speedup": round((n / wall) / seq_ips, 3),
        "mean_batch": round(mean_batch, 2),
        "batches_run": batcher.batches_run,
        "compile_warmup_s": round(compile_s, 1),
    }


def start_server(pipe, max_batch: int = 4, batch_window_ms: float = 50.0):
    """The batcher over `pipe` and its HTTP front end on an ephemeral
    loopback port, both serving: (batcher, server, port, thread)."""
    from sd_tpu_torch.serve import BatchingServer, make_http_server

    batcher = BatchingServer(pipe, max_batch=max_batch, batch_window_ms=batch_window_ms)
    batcher.start()
    server = make_http_server(batcher, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return batcher, server, server.server_address[1], thread


def stop_server(batcher, server, thread) -> None:
    server.shutdown()
    server.server_close()
    thread.join(10)
    batcher.stop()


def _pipeline(config, device):
    from sd_tpu_torch.pipeline import Text2ImagePipeline

    return Text2ImagePipeline(config, device=device)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="sd_v1",
                    help="a config name, .json or .yaml (default sd_v1)")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=3,
                    help="requests per client in the concurrent phase")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--batch-window-ms", type=float, default=50.0)
    ap.add_argument("--rows", default="ddim50,lcm4",
                    help="comma list of: " + ", ".join(ROWS))
    ap.add_argument("--out", default=None, help="write the rows' JSON here")
    ap.add_argument("--smoke", action="store_true",
                    help="the tiny sd_txt2img_smoke model, 3 steps a row (a self-test)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    from sd_tpu_torch.core.config import load_config, resolve_device

    device = resolve_device(args.device)
    pipe = _pipeline(load_config("sd_txt2img_smoke" if args.smoke else args.config), device)
    batcher, server, port, thread = start_server(pipe, args.max_batch, args.batch_window_ms)
    results = []
    try:
        for name in (r.strip() for r in args.rows.split(",")):
            body = dict(ROWS[name])
            if args.smoke:
                body["steps"] = min(body["steps"], 3)
            print(f"[bench_serve] row {name}: warmup+measure ({args.clients} clients x "
                  f"{args.requests} requests) ...", flush=True)
            row = run_row(name, port, batcher, body, args.clients, args.requests)
            results.append(row)
            print(json.dumps(row), flush=True)
    finally:
        stop_server(batcher, server, thread)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(f"\n{'row':8} {'img/s':>8} {'p50 s':>7} {'p99 s':>7} "
          f"{'seq img/s':>10} {'speedup':>8} {'mean batch':>10}")
    for r in results:
        print(f"{r['row']:8} {r['img_per_s']:8.3f} {r['p50_s']:7.2f} {r['p99_s']:7.2f} "
              f"{r['seq_img_per_s']:10.3f} {r['batching_speedup']:8.2f} "
              f"{r['mean_batch']:10.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
