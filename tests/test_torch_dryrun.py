"""The port's dry run of every parallelism axis
(``accl_tpu_torch/dryrun.py``, the counterpart of the reference's
``__graft_entry__.py``) on the CPU: ``dryrun_multichip(8, device="cpu")``
runs its seven checks against their unsharded goldens at the
reference's thresholds, and ``entry()`` gives the tiny model's forward,
held to the reference's ``entry`` on the same weights within
``test_torch_llama.py``'s bf16 rule (8 ulps of the logit scale).
"""

from __future__ import annotations

import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as G  # noqa: E402
from accl_tpu_torch import dryrun as D  # noqa: E402
from accl_tpu_torch.convert import llama_params_to_reference  # noqa: E402

TEST_LIMIT_S = 120


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test fails once it runs past TEST_LIMIT_S seconds."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past its {TEST_LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.mark.parametrize("n_ranks", [8, 4])
def test_dryrun_multichip_on_the_cpu(n_ranks):
    secs = D.dryrun_multichip(n_ranks, device="cpu")
    assert tuple(secs) == D.CHECKS
    assert all(s >= 0 for s in secs.values())


def test_dryrun_leaves_out_a_check_it_skips():
    """Over 3 ranks the 32-token sequence does not split: the sp check
    does not run, as in the reference, and has no entry."""
    secs = D.dryrun_multichip(3, device="cpu")
    assert tuple(secs) == tuple(c for c in D.CHECKS if c != "sp")


def test_dryrun_defaults_to_cuda():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            D.dryrun_multichip(8)


def test_dryrun_fails_on_a_wrong_collective(monkeypatch):
    """A pipeline that skips its last stage is finite and wrong: the dry
    run fails on it."""
    from accl_tpu_torch.parallel import pipeline as PP

    real = PP.pipeline_apply

    def short(stage_fn, params, micro, coll, replicate_out=False):
        params = {k: v.clone() for k, v in params.items()}
        params["w"][-1].zero_()
        return real(stage_fn, params, micro, coll, replicate_out)

    monkeypatch.setattr(PP, "pipeline_apply", short)
    with pytest.raises(D.DryrunFailure, match="pp"):
        D.dryrun_multichip(4, device="cpu")


def test_entry_matches_the_reference_entry():
    fn, args = D.entry(device="cpu")
    got = fn(*args)
    assert got.shape == (2, 64, 256) and got.dtype == torch.float32
    rfn, (params, tokens) = G.entry()
    assert np.array_equal(np.asarray(tokens), args[0].numpy())
    # the port's weights in the reference's model
    sd = _entry_model().state_dict()
    want = np.asarray(rfn(jax.tree.map(jnp.asarray,
                                       llama_params_to_reference(sd)),
                          tokens))
    # bf16 activations: test_torch_llama.py's rule, 8 ulps of the logit
    # scale, and greedy agreement on most positions
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=8 * ulp)
    assert (got.numpy().argmax(-1) == want.argmax(-1)).mean() >= 0.9


def _entry_model():
    from accl_tpu_torch.models import Llama, LlamaConfig
    return Llama(LlamaConfig.tiny(), device="cpu").init(
        torch.Generator().manual_seed(0))
