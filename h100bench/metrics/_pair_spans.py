"""The chunk spans of the traced predict_pairs call: the part the
`predict_pairs.*.pairs` readers share. Not a metric itself.

The spans are those `pesto_tpu_torch.utils.tracing` recorded while the
profiler ran; they are taken from the program once and kept on the run. A
program without that module, or a recording with no `predict_pairs` span,
gives None, and every reader then returns None.
"""


def chunks(run):
    """The attributes of the `predict_pairs.batch_encode` spans of the
    recording's last `predict_pairs` call (one per chunk); None where
    there is none."""
    if not hasattr(run, "_pair_chunks"):
        run._pair_chunks = None
        if run.trace is None:
            return None
        try:
            from pesto_tpu_torch.utils import tracing
        except ImportError:  # a program that records no spans
            return None
        recording = tracing.take()
        calls = [s for s in recording.spans if s.name == "predict_pairs"]
        if calls:
            call = max(calls, key=lambda s: s.start_ns)
            run._pair_chunks = [s.attrs for s in recording.spans
                                if s.name == "predict_pairs.batch_encode" and s.attrs.get("call") == call.span_id]
    return run._pair_chunks or None
