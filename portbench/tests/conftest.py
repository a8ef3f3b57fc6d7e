"""Shared fixtures of the benchmark's own tests: the cells at sizes a CPU
test run holds, and the fused trainer's stand-in for the CPU."""

import pytest
import torch

from .cells import ROOT  # noqa: F401  (puts the checkout on the path)


@pytest.fixture
def fused_train_on_cpu(monkeypatch):
    """The fused trainer's plain version on the kernel's own Philox
    streams: on the CPU the port draws other streams, which the reference
    (built for the kernel's) would not follow."""
    from bayesic_tpu_torch.ops import _kernel_common as kc
    from bayesic_tpu_torch.ops import fused_vae as fv

    def standin(x, params, m, v, *, steps, lr, seed, batch=256, t0=0, **kw):
        idx, eps = kc.philox_streams(seed, t0, steps, batch, x.shape[0],
                                     params["wmu"].shape[1])
        p, mm, vv, losses = fv.reference_train(
            x, params, m, v, idx_stream=idx, eps_stream=eps, lr=lr, t0=t0)
        return p, mm, vv, kc.thin_losses(losses, steps)

    monkeypatch.setattr(fv, "fused_train", standin)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
