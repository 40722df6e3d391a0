"""The loss spike of ``cs_adam`` on the LM is the algorithm's, in the JAX
package as in the port.

At qwen2-0.5b's full width, the port's ``cs_adam`` loss climbs from 12.1
to 86.7 within six steps while ``dense_adam`` and ``cs_adam_v`` (the
first moment dense) fall (``chip_smoke.py`` phase 11).  The reference
cannot run there: its full width does not fit a CPU test.  This test
runs both packages at qwen2-0.5b's ``reduced()`` depth with its full
d_model of 896, a 16,384-row vocabulary (sketched 3 x 1,280, from the
config's own compression) and ``ZipfLM`` batches of 2 x 256 tokens at
lr 1e-3, from one converted start, 6 steps:

* the reference's ``cs_adam`` loss at step 6 is more than twice its
  first, while its ``dense_adam`` and ``cs_adam_v`` losses fall below
  their first;
* the port's ``cs_adam`` follows the reference through the spike: every
  loss within rtol 2e-3 (measured 6.1e-4 at the spike step and at most
  1.3e-5 before it; the sketched tables' cancelling cells make the two
  packages' trajectories part there, see ``test_torch_lm_step.py``,
  which holds the step itself at rtol 1e-4 / atol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.train import steps as JS
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.data import ZipfLM, ZipfLMConfig
from repro_torch.train import steps as TS

CPU = torch.device("cpu")
SHAPE = dict(vocab_size=16_384, d_model=896)
STEPS, BATCH, SEQ, LR = 6, 2, 256, 1e-3
LOSS_RTOL = 2e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batches():
    data = ZipfLM(ZipfLMConfig(vocab_size=SHAPE["vocab_size"], seq_len=SEQ,
                               global_batch=BATCH, seed=0))
    return [{k: np.asarray(v) for k, v in data.batch(i).items()}
            for i in range(STEPS)]


def _jax_losses(mode, batches):
    cfg = jconfigs.get("qwen2_0_5b").reduced(**SHAPE)
    ts = JS.make_train_step(cfg, optimizer=mode, kernel_backend="xla",
                            lr=LR)
    params = ts.init_fn(jax.random.PRNGKey(0))
    state = ts.optimizer.init(params)
    start = (jax.device_get(params), jax.device_get(state))
    step = jax.jit(ts.step_fn)
    losses = []
    for b in batches:
        params, state, m = step(params, state,
                                {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, start


def test_cs_adam_spike_is_the_reference_algorithms():
    batches = _batches()
    j_cs, (p0, s0) = _jax_losses("cs_adam", batches)
    assert j_cs[-1] > 2 * j_cs[0], j_cs
    for mode in ("dense_adam", "cs_adam_v"):
        losses, _ = _jax_losses(mode, batches)
        assert losses[-1] < losses[0] and max(losses) <= losses[0], \
            (mode, losses)

    cfg = tconfigs.get("qwen2_0_5b").reduced(**SHAPE)
    ts = TS.make_train_step(cfg, optimizer="cs_adam", kernel_backend="xla",
                            lr=LR, device=CPU)
    assert tuple(ts.optimizer.init(convert.tree_from_numpy(p0, CPU))[
        "v"]["tok_embed"]["table"].shape) == (3, 1_280, 896)
    params = convert.tree_from_numpy(p0, CPU)
    state = convert.tree_from_numpy(s0, CPU)
    t_cs = []
    for b in batches:
        params, state, m = ts.step_fn(
            params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        t_cs.append(float(m["loss"]))
    np.testing.assert_allclose(t_cs, j_cs, rtol=LOSS_RTOL, atol=0)
