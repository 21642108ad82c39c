"""The open-loop load generator of the serving mixes, run in a process of
its own (it shares no interpreter lock with the server).

The process makes the requests itself from the seed: distinct structures
under the mix's size law, each written as PDB text, and arrivals at the
mix's fixed rate (exponential gaps at stratified quantiles, in a seeded
order, so every seed offers the same load in another order). It sends a
few warm-up requests, reports ready, waits for the start time, then sends
each request when it is due over its own connection. Each request is
timed from when it was due to the end of its reply. It sends back every
request's (due, sent, done, status) and, for a seeded sample of the
answered requests (the largest among them), the request body and the
reply, for the check.
"""

import asyncio
import json
import time

import numpy as np

from h100bench import harness, structures


def plan(mix: dict, seed: int, seconds: float):
    """(arrival offsets [s], records, kinds) of a window of `seconds`."""
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    rng = np.random.default_rng([int(seed), 3])
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / mix["rate_per_s"]
    gaps = rng.permutation(gaps)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    law = mix["residues"]
    recs, kinds = structures.make_records(seed, n, law["median"], law["sigma"], law["min"], law["max"],
                                          max_atoms=mix["max_atoms"], with_kinds=True)
    return due, recs, kinds


async def _post(host, port, body: bytes, timeout: float):
    reader, writer = await asyncio.wait_for(asyncio.open_connection(host, port), timeout)
    try:
        writer.write(b"POST /v1/predict HTTP/1.1\r\nHost: %s\r\nContent-Type: chemical/x-pdb\r\n"
                     b"Connection: close\r\nContent-Length: %d\r\n\r\n" % (host.encode(), len(body)))
        writer.write(body)
        await writer.drain()
        head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), timeout)
        status = int(head.split(b" ", 2)[1])
        length = 0
        for line in head.split(b"\r\n")[1:]:
            if line.lower().startswith(b"content-length:"):
                length = int(line.split(b":", 1)[1])
        payload = await asyncio.wait_for(reader.readexactly(length), timeout)
        return status, payload
    finally:
        writer.close()


async def _send_all(host, port, bodies, due, t0, grace):
    clock = time.perf_counter
    rows = [None] * len(bodies)
    replies = [None] * len(bodies)

    async def one(i):
        await asyncio.sleep(max(0.0, t0 + due[i] - clock()))
        sent = clock()
        try:
            left = t0 + due[-1] + grace - sent
            status, payload = await _post(host, port, bodies[i], max(left, 1.0))
        except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError, ValueError, IndexError):
            status, payload = -1, b""
        rows[i] = (float(due[i]), sent - t0, clock() - t0, status)
        replies[i] = payload if status == 200 else None

    await asyncio.gather(*(one(i) for i in range(len(bodies))))
    return rows, replies


def client(conn, mix, seed, seconds, host, port):
    """The child process: build, warm up, report ready, receive the start
    time, send, report."""
    due, recs, kinds = plan(mix, seed, seconds)
    bodies = [structures.pdb_text(r, k) for r, k in zip(recs, kinds)]
    wrec, wkinds = structures.make_records(int(seed) + 1, mix["warmup_requests"], mix["residues"]["median"],
                                           mix["residues"]["sigma"], mix["residues"]["min"],
                                           mix["residues"]["max"], max_atoms=mix["max_atoms"],
                                           with_kinds=True)
    warm = [structures.pdb_text(r, k) for r, k in zip(wrec, wkinds)]
    for burst in range(0, len(warm), mix["warmup_burst"]):
        part = warm[burst : burst + mix["warmup_burst"]]
        asyncio.run(_send_all(host, port, part, np.zeros(len(part)), time.perf_counter(), 300.0))
    conn.send(("ready", len(bodies)))
    t0_wall = conn.recv()
    t0 = time.perf_counter() + (t0_wall - time.time())
    rows, replies = asyncio.run(_send_all(host, port, bodies, due, t0, mix["grace_s"]))
    sizes = [len(r["xyz"]) for r in recs]
    answered = [i for i, r in enumerate(rows) if r[3] == 200]
    picked = harness.sample(seed, answered, sizes, mix["check_sample"])
    conn.send(("done", rows, {i: (bodies[i], json.loads(replies[i])) for i in picked}))
    conn.close()
