"""Host ms per structure in predict_batch's record encode and batch encode
over the window (the Predictor's own stage_ms; the stages overlap the
device's work, so they attribute time rather than add up)."""


def read(run):
    st = run.counters.get("stage_ms")
    if not st or not run.counters.get("structures"):
        return None
    return (st["record_encode"] + st["batch_encode"]) / run.counters["structures"]
