"""Host ms per step that the training loop waited for the loader's next
batch, the mean over the window's steps."""


def read(run):
    waits = run.spans.get("loader.wait_s")
    return 1e3 * sum(waits) / len(waits) if waits else None
