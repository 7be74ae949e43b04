"""The frozen-cluster streaming classifier (models/streaming.py) against
hdpgpc_tpu.models.streaming, float64 on the CPU, at the case of
tests/test_parallel.py:95-109 (T = 24, K = 3, 800 beats).

Labels must be identical; f, P and fmsg equal to 1e-9 relative; counts
equal by value (hdpgpc_tpu's counts turn float64 through its float64
mask, the port's keep the state's dtype)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdpgpc_torch import convert
from hdpgpc_torch.models import streaming as ts
from hdpgpc_tpu.data.loader import synthetic_beats
from hdpgpc_tpu.models import streaming as js

# (T, T) products at test sizes gain nothing from threads, and the
# suite runs one process per core
torch.set_num_threads(1)

T, K, N = 24, 3, 800


@pytest.fixture(scope="module")
def beats():
    y, z = synthetic_beats(N, T=T, n_clusters=K, noise=0.05, seed=2)
    tmpl = np.stack([y[:100][z[:100] == k][:, :, 0].mean(0)
                     for k in range(K)])
    return y[:, :, 0], z, tmpl


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _assert_states_match(st, sj):
    for f in ("f", "P", "fmsg"):
        assert _rel(getattr(st, f).numpy(), getattr(sj, f)) < 1e-9, f
    for f in ("A", "Gamma", "C", "Sigma", "trans_log_pi"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)))
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(sj.counts))
    assert st.counts.dtype == st.f.dtype


# chunk 256: a ragged last chunk of 32 beats; 350: of 100
@pytest.mark.parametrize("chunk", [256, 350])
def test_stream_classify_matches_jax(beats, chunk):
    Y, z, tmpl = beats
    sj, lj = js.stream_classify(
        js.init_stream_state(jnp.asarray(tmpl), ini_gamma=0.001,
                             ini_sigma=0.05), Y, chunk=chunk)
    st, lt = ts.stream_classify(
        ts.init_stream_state(torch.tensor(tmpl), 0.001, 0.05), Y,
        chunk=chunk)
    np.testing.assert_array_equal(lt, np.asarray(lj))
    _assert_states_match(st, sj)
    assert float(np.mean(lt == z)) > 0.95
    assert float(st.counts.sum()) == N


def test_stream_continues_from_a_jax_state(beats):
    """frozen_stream_state_from_numpy: hdpgpc_tpu's state after the
    first 300 beats, handed to the port, classifies the rest as
    hdpgpc_tpu does."""
    Y, _z, tmpl = beats
    sj = js.init_stream_state(jnp.asarray(tmpl), ini_gamma=0.001,
                              ini_sigma=0.05)
    sj, _ = js.stream_classify(sj, Y[:300], chunk=300)
    st = convert.frozen_stream_state_from_numpy(
        js.StreamState(*[np.asarray(v) for v in sj]))
    sj2, lj = js.stream_classify(sj, Y[300:], chunk=250)
    st2, lt = ts.stream_classify(st, Y[300:], chunk=250)
    np.testing.assert_array_equal(lt, np.asarray(lj))
    _assert_states_match(st2, sj2)


def test_chunk_sized_from_memory(beats, monkeypatch):
    """stream_chunk: LIVE_TT_PER_BEAT (T, T) matrices per cluster and
    beat in CHUNK_MEMORY_FRACTION of the free bytes; stream_classify
    without a chunk takes it from free_memory (faked here), capped at
    the stream's length, and labels as with that chunk given."""
    per_beat = ts.LIVE_TT_PER_BEAT * 64 * 90 * 90 * 4
    free = 80 * 2 ** 30
    c = ts.stream_chunk(64, 90, torch.float32, free)
    assert c == int(ts.CHUNK_MEMORY_FRACTION * free) // per_beat
    assert ts.stream_chunk(64, 90, torch.float64, free) == \
        int(ts.CHUNK_MEMORY_FRACTION * free) // (2 * per_beat)
    assert ts.stream_chunk(64, 90, torch.float32, 10) == 1
    Y, _z, tmpl = beats
    fake = int(130 * ts.LIVE_TT_PER_BEAT * K * T * T * 8
               / ts.CHUNK_MEMORY_FRACTION) + 1
    monkeypatch.setattr(ts, "free_memory", lambda dev: fake)
    assert ts.stream_chunk(K, T, torch.float64, fake) == 130
    st0 = ts.init_stream_state(torch.tensor(tmpl), 0.001, 0.05)
    _st, la = ts.stream_classify(st0, Y)
    _st, lb = ts.stream_classify(st0, Y, chunk=130)
    np.testing.assert_array_equal(la, lb)


def test_init_stream_state_device():
    tmpl = np.zeros((2, 5))
    st = ts.init_stream_state(torch.tensor(tmpl), 0.001, 0.05)
    assert st.f.device.type == "cpu" and st.f.dtype == torch.float64
    assert st.counts.dtype == torch.float64
    assert ts.init_stream_state(tmpl, 0.001, 0.05, device="cpu").P.shape \
        == (2, 5, 5)
    if not torch.cuda.is_available():
        # numpy templates default to the card, and raise without one
        with pytest.raises(RuntimeError):
            ts.init_stream_state(tmpl, 0.001, 0.05)
