"""Serving: `POST /v1/predict` of `pesto_tpu_torch.serve.make_server`
under an open loop at a fixed rate.

Set-up makes the seed's weights on the card and starts the server
(`BatchingService` and `make_server` with their defaults, on an ephemeral
port of 127.0.0.1) and the load generator in a process of its own
(`loadgen.py`), which makes its requests, warms the server up and waits.
The window starts at a time the driver gives it; every request is timed
from when it was due, and one that fails or never comes counts as taking
the window and the grace period whole. After the window a seeded sample of
the replies is held against the reference run on the request bodies.
"""

import http.client
import json
import multiprocessing
import threading
import time

import numpy as np
import torch

from h100bench import common, harness, loadgen
from h100bench.reference import pdb as ref_pdb
from h100bench.reference import pesto as ref


def _stats(port) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/v1/stats")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def run(cell, ctx) -> harness.Run:
    from pesto_tpu_torch.infer import Predictor
    from pesto_tpu_torch.ops import _build
    from pesto_tpu_torch.serve import BatchingService, make_server

    cfg, mix, seed, seconds = cell.config, cell.mix, ctx["seed"], ctx["seconds"]
    dev = torch.device(ctx["device"])
    cuda = dev.type == "cuda"
    pred = Predictor(common.program_config(cfg), ref.make_weights(cfg, seed, dev), device=dev)
    service = BatchingService(pred)
    server = make_server(service, host="127.0.0.1", port=0)
    port = server.server_address[1]
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    mp = multiprocessing.get_context("spawn")
    conn, child_conn = mp.Pipe()
    gen = mp.Process(target=loadgen.client, args=(child_conn, mix, seed, seconds, "127.0.0.1", port))
    gen.start()
    run = harness.Run(config=cfg)
    try:
        if cuda:
            _build.build_all(("knn", "edge_attention"))
        if not conn.poll(mix["setup_limit_s"]):
            raise RuntimeError("the load generator was not ready in time")
        conn.recv()
        harness.note(ctx["t0"], "server, kernels, requests made, warm-up")
        before = _stats(port)
        t0 = time.time() + 0.1
        conn.send(t0)
        run.values["setup_s"] = t0 - ctx["t0"]
        if ctx["trace"]:
            time.sleep(max(0.0, t0 + seconds / 3 - time.time()))
            _, make_trace, _ = harness.profile(lambda: time.sleep(seconds / 3))
            run.trace = make_trace()
        if not conn.poll(seconds + mix["grace_s"] + 60):
            raise RuntimeError("the load generator did not report")
        _, rows, checked = conn.recv()
        after = _stats(port)
    finally:
        gen.join(timeout=30)
        if gen.is_alive():
            gen.terminate()
            gen.join()
        server.shutdown()
        server.server_close()
        service.close()
    if "rows" in ctx:
        ctx["rows"]["rows"] = rows
    rows = np.array(rows, dtype=np.float64)  # due, sent, done, status (s from t0)
    ok = rows[:, 3] == 200
    missing = seconds + mix["grace_s"]
    latency = np.where(ok, rows[:, 2] - rows[:, 0], missing)
    run.attempted, run.failed = len(rows), int((~ok).sum())
    run.window_s = float(max(rows[:, 2].max(), seconds))
    run.values["serve_p95_ms"] = float(np.percentile(latency, 95)) * 1e3
    late = (rows[:, 1] - rows[:, 0]) * 1e3
    run.extra["loadgen"] = {"requests": len(rows), "late_p95_ms": float(np.percentile(late, 95)),
                            "late_max_ms": float(late.max()), "status_429": int((rows[:, 3] == 429).sum()),
                            "latency_p50_ms": float(np.percentile(latency, 50)) * 1e3}
    run.counters["stats_before"], run.counters["stats_after"] = before, after
    if cuda:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    del pred, service, server
    common.free_memory()

    harness.note(ctx["t0"], "window closed")
    picked = sorted(checked)
    records = [ref_pdb.read(checked[i][0]) for i in picked]
    answers = [np.asarray(checked[i][1]["probabilities"], np.float64) for i in picked]
    gaps = (common.prob_gaps(cfg, seed, records, answers, dev, control=ctx.get("control", False))
            if picked else {"answer_error_ratio": float("inf")})
    for name, lim in cell.limits.items():
        run.check(name, gaps[name], lim["limit"])
    run.extra["readings"] = gaps
    harness.note(ctx["t0"], "checked")
    return run
