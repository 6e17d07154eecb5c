"""The port's training forward on a batch of two items against the JAX
package's, on the CPU: the forward of JAX's ``loss_fn`` (one jit, no
gradient) at the step setting of ``tests/torch_port_cases.py``.  Its own
file: the one JAX program here is not the gradient program of
``test_torch_port_train_step.py``, and two cold JAX compiles in one file
run one after the other."""

import numpy as np
import torch

from torch_port_threads import torch_threads  # noqa: F401 (autouse)

from rvos_tpu_torch.configs import tiny_test
from rvos_tpu_torch.engine.train import Trainer, batch_to_device
from torch_port_cases import STEP, TRAIN_KW, jax_params, step_key, train_batch


def test_two_item_losses_match_jax():
    """A batch of two items (two objects and one): the forward of JAX's
    ``loss_fn`` (jitted without the gradient) against the port's, so the
    per-item k-means keys, object masks and the mean over items are
    JAX's.  Losses within 1e-4 relative, IoUs within 1e-6."""
    import jax
    import jax.numpy as jnp
    import optax

    from rvos_tpu.configs import tiny_test as j_tiny
    from rvos_tpu.engine.train import make_train_step
    from rvos_tpu.models.aocnet import AOCNet as JAOCNet

    tr = Trainer(tiny_test(**TRAIN_KW), device="cpu", seed=2)
    params = jax_params(tr.model.state_dict())
    batch = train_batch(3, b=2)
    step = make_train_step(j_tiny(**TRAIN_KW), JAOCNet(j_tiny(**TRAIN_KW)),
                           optax.sgd(0.1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jkey = jax.random.split(jax.random.PRNGKey(1234))[1]
    _, (jlosses, jious, _) = jax.jit(
        lambda p: step.loss_fn(p, jb, jnp.asarray(STEP), jkey))(params)
    with torch.no_grad():
        _, (losses, ious, _) = tr._step_fn.loss_fn(
            batch_to_device(batch, torch.device("cpu")), STEP, step_key())
    rel = np.abs(losses.numpy() - np.asarray(jlosses)) / np.abs(jlosses)
    assert rel.max() <= 1e-4, (losses, jlosses)
    np.testing.assert_allclose(ious.numpy(), np.asarray(jious), rtol=0,
                               atol=1e-6)
