"""The last API remainders of the port, against the JAX package: the
regression scores (`metrics.reg_scoring`), the checkpoint API's
synchronous save, `AsyncCheckpointer.save(step=)`, `.errors` and
`.wait()`; and the two serving races repaired in the port: the server's
stats copy the Predictor's stage timers under its lock, and the idle pool
of batch encoders is capped."""

import contextlib
import os
import threading

import numpy as np
import pytest
import torch

from pesto_tpu.metrics import reg_scoring as jax_reg_scoring
from pesto_tpu.train import create_train_state as jax_create_state
from pesto_tpu.train.checkpoint import AsyncCheckpointer as JaxAsyncCheckpointer
from pesto_tpu.train.checkpoint import latest_step as jax_latest_step
from pesto_tpu_torch.batching import BatchEncoder
from pesto_tpu_torch.infer import Predictor
from pesto_tpu_torch.metrics import reg_scoring
from pesto_tpu_torch.models import get_config
from pesto_tpu_torch.port import init_state_dict
from pesto_tpu_torch.serve import BatchingService
from pesto_tpu_torch.synthetic import random_structure_record
from pesto_tpu_torch.train import checkpoint as ck
from pesto_tpu_torch.train import create_train_state

from tests.test_train_step import TINY


# ---- reg_scoring ---------------------------------------------------------------


@pytest.mark.parametrize("case", ["correlated", "constant_y", "three_samples"])
def test_reg_scoring_matches_jax(case, record_property):
    rng = np.random.RandomState({"correlated": 0, "constant_y": 1, "three_samples": 2}[case])
    y = rng.randn(200).astype(np.float32)
    p = (0.7 * y + 0.3 * rng.randn(200)).astype(np.float32)
    if case == "constant_y":
        y = np.full(200, 0.25, np.float32)
    if case == "three_samples":
        y, p = y[:3], p[:3]
    got, want = reg_scoring(y, p), jax_reg_scoring(y, p)
    assert sorted(got) == sorted(want) == ["mae", "mse", "pcc", "rmse", "std"]
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == want[k], (k, got[k], want[k])
    assert np.isnan(got["pcc"]) == (case == "constant_y")
    record_property("max_abs_dev_jax", max(abs(got[k] - want[k]) for k in want if not np.isnan(want[k])))


# ---- the checkpoint API ---------------------------------------------------------


def _port_state():
    base = get_config("i_v4_1")
    cfg = base.replace(layers=(base.layers[0],) * 2)
    return create_train_state(cfg, 1e-3, device="cpu")


def test_save_checkpoint_writes_now_under_its_step(tmp_path):
    state = _port_state()
    state.global_step = 4
    assert ck.save_checkpoint(str(tmp_path / "a"), state) == 4
    assert ck.latest_step(str(tmp_path / "a")) == 4  # written before it returns
    assert ck.save_checkpoint(str(tmp_path / "a"), state, step=9) == 9
    assert ck.latest_step(str(tmp_path / "a")) == 9
    fresh = ck.restore_checkpoint(str(tmp_path / "a"), _port_state(), step=9)
    assert fresh.global_step == 4  # the step names the directory, not the state's counter
    assert all(torch.equal(a, b) for a, b in zip(fresh.model.parameters(), state.model.parameters()))


def test_async_save_step_names_the_checkpoint_as_jax(tmp_path):
    """save(step=) names the step directory in both packages; the state's
    own step is the default."""
    jstate, _ = jax_create_state(TINY, learning_rate=1e-3)
    state = _port_state()
    for saver, s, d in ((JaxAsyncCheckpointer(), jstate, tmp_path / "jax"), (ck.AsyncCheckpointer(), state,
                                                                              tmp_path / "port")):
        assert saver.save(str(d), s) == 0
        assert saver.save(str(d), s, step=7) == 7
        saver.wait()
        saver.close()
        assert saver.errors == []
    assert jax_latest_step(str(tmp_path / "jax")) == ck.latest_step(str(tmp_path / "port")) == 7
    assert sorted(os.listdir(tmp_path / "port")) == ["0", "7"]


def test_async_wait_blocks_until_the_write_is_done(tmp_path, monkeypatch):
    release = threading.Event()
    write = ck._write

    def held(*args):
        release.wait(timeout=30)
        write(*args)

    monkeypatch.setattr(ck, "_write", held)
    saver = ck.AsyncCheckpointer()
    state = _port_state()
    saver.save(str(tmp_path / "c"), state, step=3)
    waiter = threading.Thread(target=saver.wait)
    waiter.start()
    waiter.join(timeout=0.5)
    assert waiter.is_alive() and ck.latest_step(str(tmp_path / "c")) is None
    release.set()
    waiter.join(timeout=30)
    assert not waiter.is_alive() and ck.latest_step(str(tmp_path / "c")) == 3
    saver.close()


def test_async_errors_surface_a_failed_write_as_jax(tmp_path):
    """A save into a path that is a file fails on the writer thread: both
    packages keep it in .errors, and wait() and close() raise it."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    jstate, _ = jax_create_state(TINY, learning_rate=1e-3)
    for saver, s in ((JaxAsyncCheckpointer(), jstate), (ck.AsyncCheckpointer(), _port_state())):
        saver.save(str(blocker / "ckpt"), s)
        with pytest.raises(Exception) as raised:
            saver.wait()
        assert len(saver.errors) == 1 and raised.value is saver.errors[0]
        with pytest.raises(Exception):
            saver.close()


# ---- the serving races ---------------------------------------------------------------


@pytest.fixture(scope="module")
def pred():
    base = get_config("i_v4_0")
    cfg = base.replace(layers=(base.layers[0],))
    return Predictor(cfg, init_state_dict(cfg, seed=0), device="cpu")


def test_stats_copy_stage_ms_under_the_predictors_lock(pred):
    svc = BatchingService(pred, max_batch=4, max_wait_ms=1.0)
    try:
        out = {}
        with pred._stage_lock:
            reader = threading.Thread(target=lambda: out.setdefault("st", svc.snapshot()))
            reader.start()
            reader.join(timeout=0.5)
            assert reader.is_alive()  # waits for the lock the batcher threads write under
        reader.join(timeout=30)
        assert not reader.is_alive()
        assert sorted(out["st"]["predictor_stage_ms"]) == sorted(pred.stage_ms)
    finally:
        assert svc.close()


def test_idle_encoder_pool_is_capped_after_concurrent_callers(pred, monkeypatch):
    """N callers that each hold an encoder at once (a barrier inside
    predict_batch): N encoders are made, at most ENC_POOL_IDLE stay idle
    and the others are closed; the results equal one caller's."""
    n = 6
    closed = []
    close = BatchEncoder.close

    def counting_close(self):
        closed.append(self)
        close(self)

    monkeypatch.setattr(BatchEncoder, "close", counting_close)
    while not pred._enc_pool.empty():
        pred._enc_pool.get_nowait()
    barrier = threading.Barrier(n, timeout=60)
    checkout = pred._encoder
    held = []

    @contextlib.contextmanager
    def together(*args):
        with checkout(*args) as enc:
            held.append(enc)
            barrier.wait()
            yield enc

    monkeypatch.setattr(pred, "_encoder", together)
    recs = [random_structure_record(n_atoms=80 + 10 * i, n_res=12, seed=40 + i) for i in range(2)]
    out = [None] * n

    def call(i):
        out[i] = pred.predict_batch(recs, num_threads=1)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len({id(e) for e in held}) == n
    assert pred._enc_pool.qsize() == Predictor.ENC_POOL_IDLE
    assert len(closed) == n - Predictor.ENC_POOL_IDLE
    monkeypatch.setattr(pred, "_encoder", checkout)
    want = pred.predict_batch(recs, num_threads=1)
    for got in out:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert pred._enc_pool.qsize() <= Predictor.ENC_POOL_IDLE
