"""The UNet's remat policies in training, at the oracle TINY dims on the CPU.

A TINY CamContextI2V (seeded weights, the ResBlocks' dropout at 0.1, block
remat on) takes one micro-step's loss and trainable gradients
(`parallel/trainer.py::loss_and_grads`) under each policy, chosen by
`CAMC2V_REMAT_POLICY`:

  * every policy's loss and gradients are bit-identical to `none`'s: a saved
    output is the one the recompute would make (the CPU twins are
    deterministic, and the recompute draws the same dropout masks);
  * under `pallas` and `dots_pallas` the backward re-runs no forward of the
    dispatcher op that carries the kernels (`ops.saved_forward`: on the CPU
    the GroupNorm and flash attention twins' forwards), while under `none`,
    `dots` and `dots_batch` it re-runs every one the forward ran.

In a file of two tests, which the tier-1 run starts beside `test_tp.py`.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from test_torch_camera_generate import batches, plain_tiny  # noqa: E402
from test_torch_port_modules import one_torch_thread, port_config  # noqa: E402,F401

from camc2v_tpu_torch import ops  # noqa: E402
from camc2v_tpu_torch.parallel import trainer as TR  # noqa: E402

POLICIES = ["none", "dots", "dots_batch", "pallas", "dots_pallas"]


@pytest.fixture(scope="module")
def tiny_training():
    from camc2v_tpu_torch.models.camcontexti2v import CamContextI2V
    from camc2v_tpu_torch.utils.weights import init_weights

    cfg = port_config(plain_tiny("camcontext").config)
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, dropout=0.1, remat=True))
    model = CamContextI2V(cfg, dtype=torch.float32)
    init_weights(model, torch.Generator().manual_seed(1))
    model.train()
    params = [p for n, p in model.named_parameters() if n.startswith(("unet.", "adaptor."))]
    for p in model.parameters():
        p.requires_grad_(False)
    for p in params:
        p.requires_grad_(True)
    return model, params, batches(n_ctx=2)[1]


def test_every_policy_gives_none_gradients_bit_for_bit(tiny_training, monkeypatch):
    model, params, batch = tiny_training
    results = {}
    for policy in POLICIES:
        monkeypatch.setenv("CAMC2V_REMAT_POLICY", policy)
        loss, _, grads = TR.loss_and_grads(model, params, batch, 7)
        results[policy] = (loss.detach(), grads)
    loss0, grads0 = results["none"]
    assert sum(int(g.ne(0).any()) for g in grads0) > 0.9 * len(grads0)
    for policy, (loss, grads) in results.items():
        assert torch.equal(loss, loss0), policy
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0)), policy


def test_pallas_policies_rerun_no_kernel_forward_in_the_backward(tiny_training, monkeypatch):
    model, params, batch = tiny_training
    counts = {"now": 0}
    saved_forward = ops.saved_forward

    def counted(run, twin, *tensors):
        def counting_run(*a):
            counts["now"] += 1
            return run(*a)
        return saved_forward(counting_run, twin, *tensors)

    monkeypatch.setattr(ops, "saved_forward", counted)
    generator = torch.Generator().manual_seed(3)
    for policy in POLICIES:
        monkeypatch.setenv("CAMC2V_REMAT_POLICY", policy)
        counts["now"] = 0
        torch.manual_seed(0)
        loss, _ = model.training_loss(batch, generator)
        forward = counts["now"]
        counts["now"] = 0
        torch.autograd.grad(loss, params, allow_unused=True)
        backward = counts["now"]
        assert forward > 20, policy
        if "pallas" in policy:
            assert backward == 0, policy
        else:  # every checkpointed forward re-runs (those outside the blocks do not)
            assert 0 < backward < forward, policy
