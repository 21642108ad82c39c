"""Mean ms a request waited in the batcher's queue over the window (the
server's /v1/stats counters, before and after)."""


def read(run):
    a, b = run.counters.get("stats_before"), run.counters.get("stats_after")
    if not a or not b or b["requests"] <= a["requests"]:
        return None
    return (b["queue_wait_ms_total"] - a["queue_wait_ms_total"]) / (b["requests"] - a["requests"])
