"""Parity of the port's posterior diagnostics (``utils/diagnostics.py``)
with the JAX package's: the same numpy draws go to both, and ESS,
split-R-hat, MCSE and the autocovariance must agree to rtol 1e-5 (atol
1e-6 for autocovariances that cross zero).  Both sides compute in
float32."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesic_tpu.utils import diagnostics as jdiag
from bayesic_tpu_torch.utils import diagnostics as tdiag

torch.set_num_threads(2)


def _ar1(seed, rho, chains=4, n=200, dims=3, shift=0.0):
    """AR(1) draws (chains, n, dims): rho > 0 correlated, < 0 antithetic;
    ``shift`` offsets the chains' means (a chain that has not mixed)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((chains, n, dims))
    e = rng.normal(size=(chains, n, dims))
    x[:, 0] = e[:, 0]
    for t in range(1, n):
        x[:, t] = rho * x[:, t - 1] + np.sqrt(1 - rho * rho) * e[:, t]
    x += shift * np.arange(chains)[:, None, None]
    return x.astype(np.float32)


CASES = {
    "iid": _ar1(0, 0.0),
    "correlated": _ar1(1, 0.9),
    "antithetic": _ar1(2, -0.5),
    "unmixed": _ar1(3, 0.5, shift=0.7),
    "odd_n": _ar1(4, 0.3, n=101),
    "one_chain": _ar1(5, 0.6, chains=1, dims=1)[0, :, 0],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ess_rhat_mcse_match_jax(case):
    x = CASES[case]
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    np.testing.assert_allclose(tdiag.ess(tx).numpy(),
                               np.asarray(jdiag.ess(jx)), rtol=1e-5)
    if x.ndim > 1:
        np.testing.assert_allclose(tdiag.split_rhat(tx).numpy(),
                                   np.asarray(jdiag.split_rhat(jx)),
                                   rtol=1e-5)
        np.testing.assert_allclose(tdiag.mcse(tx).numpy(),
                                   np.asarray(jdiag.mcse(jx)), rtol=1e-5)
        np.testing.assert_allclose(
            tdiag.autocovariance(tx, axis=1).numpy(),
            np.asarray(jdiag.autocovariance(jx, axis=1)), rtol=1e-5,
            atol=1e-6)


def test_diagnostics_tell_mixed_from_unmixed():
    assert float(tdiag.split_rhat(torch.as_tensor(CASES["iid"])).max()) \
        < 1.05
    assert float(tdiag.split_rhat(torch.as_tensor(CASES["unmixed"])).min()) \
        > 1.2
    n_draws = 4 * 200
    assert float(tdiag.ess(torch.as_tensor(CASES["correlated"])).max()) \
        < 0.2 * n_draws
    # antithetic chains: tau < 1, so ESS exceeds the draw count
    assert float(tdiag.ess(torch.as_tensor(CASES["antithetic"])).min()) \
        > n_draws


def test_summary_and_print_summary_match_jax():
    samples = {"a": CASES["correlated"][:, :, 0], "b": CASES["iid"]}
    got = tdiag.summary({k: torch.as_tensor(v) for k, v in samples.items()})
    want = jdiag.summary({k: jnp.asarray(v) for k, v in samples.items()})
    for site in samples:
        for stat in ("mean", "std", "mcse", "ess", "rhat"):
            np.testing.assert_allclose(got[site][stat].numpy(),
                                       np.asarray(want[site][stat]),
                                       rtol=1e-5, atol=1e-7)
    out, jout = io.StringIO(), io.StringIO()
    tdiag.print_summary({k: torch.as_tensor(v) for k, v in samples.items()},
                        file=out)
    jdiag.print_summary({k: jnp.asarray(v) for k, v in samples.items()},
                        file=jout)
    assert out.getvalue().splitlines()[:2] == jout.getvalue().splitlines()[:2]
    assert [ln.split()[0] for ln in out.getvalue().splitlines()[2:]] == \
        ["a", "b[0]", "b[1]", "b[2]"]
