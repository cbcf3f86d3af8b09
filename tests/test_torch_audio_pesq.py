"""PESQ: the port's copy of the in-repo P.862 engine against the JAX package's.

Both packages score with the same numpy operations, so every score is held
bit for bit: the engine on the seeded corpus of ``tests/audio/pesq_corpus.py``
(read as data, not changed), the functional on batches, and the class's
float32 sum and int32 count. The fs/mode checks raise the JAX package's
errors, and an injected ``pesq_fn`` receives what the JAX package's
receives.
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from metrics_tpu.audio import PerceptualEvaluationSpeechQuality as JaxPESQ
from metrics_tpu.functional.audio._pesq_engine import pesq as jax_engine
from metrics_tpu.functional.audio.pesq import perceptual_evaluation_speech_quality as jax_pesq
from metrics_tpu_torch.audio import PerceptualEvaluationSpeechQuality
from metrics_tpu_torch.convert import state_from_jax
from metrics_tpu_torch.functional.audio import _pesq_engine
from metrics_tpu_torch.functional.audio.pesq import _default_pesq_fn, perceptual_evaluation_speech_quality
from metrics_tpu_torch.utils.imports import _PESQ_AVAILABLE
from tests.audio.pesq_corpus import _speechlike, _with_snr, build_corpus

torch.set_num_threads(2)

CORPUS = build_corpus()


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """Both engines on one BLAS thread: numpy's ``correlate`` (the time
    alignment) calls BLAS ``ddot`` once per output sample, and OpenBLAS's
    threads spin for each call on a host whose cores the suite's parallel
    workers hold (an engine call went from 0.1 s to 25 s there)."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


@pytest.mark.parametrize("item", range(len(CORPUS)), ids=[c[0] for c in CORPUS])
def test_engine_bit_equal_on_the_corpus(item):
    _, fs, mode, ref, deg = CORPUS[item]
    got = _pesq_engine.pesq(ref, deg, fs, mode)
    want = jax_engine(ref, deg, fs, mode)
    assert isinstance(got, float) and got == want


def _batch(seed, fs, n=3, seconds=2):
    rng = np.random.default_rng(seed)
    clean = np.stack([_speechlike(rng, seconds * fs, fs) for _ in range(n)])
    deg = np.stack([_with_snr(c, rng, snr) for c, snr in zip(clean, (5.0, 12.0, 25.0)[:n])])
    return deg.astype(np.float32), clean.astype(np.float32)


@pytest.mark.parametrize("fs, mode", [(8000, "nb"), (16000, "nb"), (16000, "wb")])
def test_functional_bit_equal(fs, mode):
    deg, clean = _batch(fs + len(mode), fs)
    got = perceptual_evaluation_speech_quality(torch.from_numpy(deg), torch.from_numpy(clean), fs, mode)
    want = np.asarray(jax_pesq(jnp.asarray(deg), jnp.asarray(clean), fs, mode))
    assert got.dtype == torch.float32 and got.shape == (3,) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # a [2, 1, time] batch keeps its shape; one utterance gives a 0-d score
    two = perceptual_evaluation_speech_quality(torch.from_numpy(deg[:2, None]), torch.from_numpy(clean[:2, None]), fs, mode)
    assert two.shape == (2, 1) and torch.equal(two[:, 0], got[:2])
    one = perceptual_evaluation_speech_quality(torch.from_numpy(deg[0]), torch.from_numpy(clean[0]), fs, mode)
    assert one.shape == () and float(one) == float(want[0])


@pytest.mark.parametrize("fs, mode", [(8000, "nb"), (16000, "wb")])
def test_class_bit_equal_and_carried(fs, mode):
    deg, clean = _batch(fs, fs)
    metric, jax_metric = PerceptualEvaluationSpeechQuality(fs, mode, device="cpu"), JaxPESQ(fs, mode)
    for sl in (slice(0, 2), slice(2, 3)):
        metric.update(torch.from_numpy(deg[sl]), torch.from_numpy(clean[sl]))
        jax_metric.update(jnp.asarray(deg[sl]), jnp.asarray(clean[sl]))
    assert metric.sum_pesq.dtype == torch.float32 and metric.total.dtype == torch.int32
    assert float(metric.sum_pesq) == float(jax_metric.sum_pesq) and int(metric.total) == int(jax_metric.total) == 3
    assert float(metric.compute()) == float(jax_metric.compute())
    carried = state_from_jax({k: np.asarray(getattr(jax_metric, k)) for k in jax_metric._defaults}, metric)
    assert float(metric.compute_state(carried)) == float(jax_metric.compute())
    merged = metric.merge_states(carried, carried)
    assert int(merged["total"]) == 6 and float(metric.compute_state(merged)) == float(jax_metric.compute())


def test_injected_scorer_and_default():
    calls, jax_calls = [], []
    deg, clean = _batch(3, 8000, n=2)

    def scorer(log):
        def fn(ref, deg_, fs, mode):
            log.append((ref.dtype, ref.shape, float(ref.sum()), float(deg_.sum()), fs, mode))
            return 2.5 + len(log)

        return fn

    got = perceptual_evaluation_speech_quality(torch.from_numpy(deg), torch.from_numpy(clean), 8000, "nb", pesq_fn=scorer(calls))
    want = jax_pesq(jnp.asarray(deg), jnp.asarray(clean), 8000, "nb", pesq_fn=scorer(jax_calls))
    assert calls == jax_calls and got.tolist() == np.asarray(want).tolist() == [3.5, 4.5]
    # without the ``pesq`` binding the default is the in-repo engine
    assert _PESQ_AVAILABLE or _default_pesq_fn() is _pesq_engine.pesq


def test_errors_match_jax():
    x = torch.zeros(16000)
    for fs, mode in ((44100, "nb"), (8000, "xb"), (8000, "wb")):
        with pytest.raises(ValueError) as want:
            jax_pesq(jnp.zeros(16000), jnp.zeros(16000), fs, mode)
        with pytest.raises(ValueError) as got:
            perceptual_evaluation_speech_quality(x, x, fs, mode)
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError) as want:
            JaxPESQ(fs, mode)
        with pytest.raises(ValueError) as got:
            PerceptualEvaluationSpeechQuality(fs, mode, device="cpu")
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jax_pesq(jnp.zeros((2, 4000)), jnp.zeros((3, 4000)), 8000, "nb")
    with pytest.raises(ValueError) as got:
        perceptual_evaluation_speech_quality(torch.zeros(2, 4000), torch.zeros(3, 4000), 8000, "nb")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="too short"):
        perceptual_evaluation_speech_quality(torch.zeros(100), torch.zeros(100), 8000, "nb")
