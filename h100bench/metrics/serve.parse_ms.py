"""Mean ms a request's handler spent parsing and cleaning its structure
over the window (the server's /v1/stats counters, before and after)."""


def read(run):
    a, b = run.counters.get("stats_before"), run.counters.get("stats_after")
    if not a or not b or b.get("parse_n", 0) <= a.get("parse_n", 0):
        return None
    return (b["parse_ms_total"] - a["parse_ms_total"]) / (b["parse_n"] - a["parse_n"])
