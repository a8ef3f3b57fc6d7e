"""Example 3 — Bayesian matrix factorization, ~1M ratings: a mini-batch
ELBO through the DSL, and a dense analytic ELBO over per-cell sufficient
statistics.

Counterpart of ``bayesic_tpu/models/matrix_fact.py``.  Latents: user and
item factor matrices, user and item biases, a global mean.  Entry points:

* ``run``: the generic engine — the DSL model with a subsampled plate over
  the ratings -> ``SVI`` + ``MeanFieldGuide``.  Row lookups are
  ``index_select`` with clamped indices (the JAX package's
  ``gather_reference``; its one-hot ``mxu_gather`` is a TPU workaround).
* ``run_dense``: the exact full-batch objective below, eager PyTorch
  (``torch.matmul`` over the cell grid) differentiated by autograd.
* ``ops/mf_dense.fused_train``: the same objective with the cell-space work
  in the hand-written kernel.

The dense path.  The Gaussian likelihood depends on the data only through
per-cell statistics (count, rating sum, and the sum of squares),

  sum_ratings (r - p_ij)^2 = sum_cells [sqsum_ij - 2 p_ij rsum_ij
                                        + cnt_ij p_ij^2],

and p is bilinear in the latents, so under a mean-field guide the expected
log-likelihood is closed form in q's first and second moments, and the KL
terms are analytic: the ELBO is deterministic (zero gradient variance),
with the mini-batch estimator's optimum.

The item-sharded dense path (``run_dense_sharded``): the cell grid is
additive over item columns, so each rank of a mesh axis holds one column
slice of (cnt, rsum) and the item-side guide params (v, bi), and forms
only its (U, I / P) slice of the mean and variance fields.  One
all-reduce a step sums the loss and the replicated sites' gradients.

``Config.data_file`` reads the ratings from a file in the JAX package's
format (``io.ratings``), each process its own contiguous shard; a missing
file is generated from the synthetic recipe and written first.

Run: ``python -m bayesic_tpu_torch.models.matrix_fact --smoke true`` (on
the card; add ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import dist
from ..core import plate, sample
from ..infer.svi import SVI, Adam, MeanFieldGuide, cosine_decay_schedule
from ..infer.svi.svi import tree_map
from ..ops.mf_dense import PRIORS
from ..ops.mf_dense import kl_normal as _kl_normal
from ..parallel.mesh import (Sharding, all_gather, axis_index, axis_size,
                             local_slice, psum)
from ..utils.config import dump_config, parse_config
from .common import bench_line, timed_steps

__all__ = ["Config", "make_data", "make_model", "dense_stats", "dense_init",
           "expected_loglik", "dense_neg_elbo", "run_dense",
           "dense_param_specs", "dense_neg_elbo_sharded",
           "dense_value_and_grad_sharded", "run_dense_sharded", "run",
           "main"]


@dataclasses.dataclass(frozen=True)
class Config:
    num_users: int = 3000
    num_items: int = 1500
    num_factors: int = 16
    num_ratings: int = 1_000_000
    noise: float = 0.5
    seed: int = 0
    steps: int = 2000
    batch_size: int = 8192
    lr: float = 0.02
    smoke: bool = False
    bench: bool = False
    data_file: str = ""     # a ratings file (io.ratings); written if missing
    device: str = "cuda"


_SMOKE = dict(num_users=50, num_items=30, num_factors=4, num_ratings=5000,
              steps=500)


def make_data(cfg: Config):
    """``(users (R,) int32, items (R,) int32, ratings (R,) float32,
    truth)`` as numpy: the JAX package's synthetic recipe, so both make
    identical data; from ``cfg.data_file`` when given (truth None)."""
    if cfg.data_file:
        return _data_from_file(cfg)
    return _synthetic_data(cfg)


def _data_from_file(cfg: Config, shard=True):
    """This process's shard of the file's ratings, by the JAX package's
    arithmetic: per = n // processes rows from rank * per (the last n %
    processes rows are read by none); every row with ``shard=False``.  A
    missing file is generated from the synthetic recipe and written
    first."""
    import os

    from ..io import RatingsDataset, write_ratings
    from ..parallel.launcher import _world

    if not os.path.exists(cfg.data_file):
        users, items, r, _ = _synthetic_data(cfg)
        write_ratings(cfg.data_file, users, items, r)
    world, rank = _world() if shard else (1, 0)
    with RatingsDataset(cfg.data_file) as ds:
        per = len(ds) // world
        u, i, r = ds.read_shard(rank * per, per)
    return u, i, r, None


def _synthetic_data(cfg: Config):
    rng = np.random.default_rng(cfg.seed)
    u_true = rng.normal(0, 0.5, (cfg.num_users, cfg.num_factors)) \
        .astype(np.float32)
    v_true = rng.normal(0, 0.5, (cfg.num_items, cfg.num_factors)) \
        .astype(np.float32)
    bu = rng.normal(0, 0.3, cfg.num_users).astype(np.float32)
    bi = rng.normal(0, 0.3, cfg.num_items).astype(np.float32)
    m = np.float32(3.5)
    users = rng.integers(0, cfg.num_users, cfg.num_ratings).astype(np.int32)
    items = rng.integers(0, cfg.num_items, cfg.num_ratings).astype(np.int32)
    mean = (u_true[users] * v_true[items]).sum(-1) + bu[users] + bi[items] + m
    r = (mean + rng.normal(0, cfg.noise, cfg.num_ratings)).astype(np.float32)
    return users, items, r, dict(u=u_true, v=v_true, bu=bu, bi=bi, m=m)


def _rows(table, idx):
    """``table[idx]`` with out-of-range indices clamped (the JAX package's
    ``gather_reference``, ``jnp.take``'s clip mode)."""
    return torch.index_select(table, 0, idx.clamp(0, table.shape[0] - 1))


def make_model(cfg: Config):
    nu, ni, k = cfg.num_users, cfg.num_items, cfg.num_factors
    n, noise = cfg.num_ratings, cfg.noise

    def model(users, items, ratings):
        u = sample("u", dist.Normal(*PRIORS["u"]).expand((nu, k))
                   .to_event(2))
        v = sample("v", dist.Normal(*PRIORS["v"]).expand((ni, k))
                   .to_event(2))
        bu = sample("bu", dist.Normal(*PRIORS["bu"]).expand((nu,))
                    .to_event(1))
        bi = sample("bi", dist.Normal(*PRIORS["bi"]).expand((ni,))
                    .to_event(1))
        m = sample("m", dist.Normal(*PRIORS["m"]))
        with plate("ratings", n, subsample_size=cfg.batch_size) as idx:
            uid, iid = users[idx], items[idx]
            mean = (torch.sum(_rows(u, uid) * _rows(v, iid), -1)
                    + _rows(bu, uid) + _rows(bi, iid) + m)
            sample("obs", dist.Normal(mean, noise).to_event(1),
                   obs=ratings[idx])

    return model


def _tensors(cfg: Config):
    users, items, ratings, truth = make_data(cfg)
    device = torch.device(cfg.device)
    return (torch.as_tensor(users, device=device),
            torch.as_tensor(items, device=device),
            torch.as_tensor(ratings, device=device), truth)


def _rmse(mean_u, users, items, ratings):
    """RMSE of the posterior-mean predictor on the held-in ratings."""
    pred = (torch.sum(mean_u["u"][users] * mean_u["v"][items], -1)
            + mean_u["bu"][users] + mean_u["bi"][items] + mean_u["m"])
    return float(torch.sqrt(torch.mean((pred - ratings) ** 2)))


# ---------------------------------------------------------------------------
# dense sufficient-statistics path
# ---------------------------------------------------------------------------

def dense_stats(users, items, ratings, num_users, num_items, device="cpu"):
    """Per-cell sufficient statistics: ``(cnt, rsum)`` dense float32
    tensors on ``device`` (summed in float64 numpy, as the JAX package
    does), the scalar sum of squared ratings and the rating count."""
    u = np.asarray(users.cpu() if isinstance(users, torch.Tensor) else users)
    i = np.asarray(items.cpu() if isinstance(items, torch.Tensor) else items)
    r = np.asarray(ratings.cpu() if isinstance(ratings, torch.Tensor)
                   else ratings, np.float64)
    cnt = np.zeros((num_users, num_items), np.float64)
    rsum = np.zeros((num_users, num_items), np.float64)
    np.add.at(cnt, (u, i), 1.0)
    np.add.at(rsum, (u, i), r)
    return (torch.as_tensor(cnt, dtype=torch.float32, device=device),
            torch.as_tensor(rsum, dtype=torch.float32, device=device),
            float((r * r).sum()), int(r.shape[0]))


def dense_init(cfg: Config, generator=None, init_scale=0.1, device=None):
    """Mean-field guide params ``{site: (loc, log_scale)}`` for the dense
    objective — the sites and shapes of ``MeanFieldGuide`` on
    ``make_model``; factor locs 0.01 N(0, 1) from ``generator`` (a CPU
    generator seeded with ``cfg.seed`` by default), the rest fixed."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(cfg.seed)
    device = torch.device(device if device is not None else cfg.device)
    nu, ni, k = cfg.num_users, cfg.num_items, cfg.num_factors
    ils = math.log(init_scale)

    def full(*shape):
        return torch.full(shape, ils, device=device)

    return {
        "u": ((0.01 * torch.randn(nu, k, generator=gen)).to(device),
              full(nu, k)),
        "v": ((0.01 * torch.randn(ni, k, generator=gen)).to(device),
              full(ni, k)),
        "bu": (torch.zeros(nu, device=device), full(nu)),
        "bi": (torch.zeros(ni, device=device), full(ni)),
        "m": (torch.tensor(3.0, device=device), torch.tensor(ils,
                                                             device=device)),
    }


def expected_loglik(params, cnt, rsum, sqsum, n_ratings, noise):
    """Closed-form E_q[log p(ratings | theta)] under the mean-field guide:
    the likelihood is quadratic in p and p is bilinear in independent
    Gaussians, so only q's first and second moments enter."""
    (u_loc, u_ls), (v_loc, v_ls) = params["u"], params["v"]
    (bu_loc, bu_ls), (bi_loc, bi_ls) = params["bu"], params["bi"]
    m_loc, m_ls = params["m"]
    u_var, v_var = torch.exp(2.0 * u_ls), torch.exp(2.0 * v_ls)
    mean = u_loc @ v_loc.T + bu_loc[:, None] + bi_loc[None, :] + m_loc
    # Var(sum_c u_c v_c) = sum_c E[u^2]E[v^2] - mu_u^2 mu_v^2
    var = ((u_loc ** 2 + u_var) @ (v_loc ** 2 + v_var).T
           - (u_loc ** 2) @ (v_loc ** 2).T
           + torch.exp(2.0 * bu_ls)[:, None] + torch.exp(2.0 * bi_ls)[None, :]
           + torch.exp(2.0 * m_ls))
    # sum_cells cnt (var + mean^2) - 2 rsum mean   (+ sqsum, a constant)
    quad = torch.sum(cnt * (var + mean * mean) - 2.0 * rsum * mean) + sqsum
    return (-0.5 / noise ** 2) * quad \
        - n_ratings * (math.log(noise) + 0.5 * math.log(2.0 * math.pi))


def dense_neg_elbo(params, cnt, rsum, sqsum, n_ratings, noise):
    """-ELBO, fully analytic (expected log-lik + closed-form KLs).  Prior
    scales match ``make_model``: u, v ~ N(0, 1); bu, bi ~ N(0, .5);
    m ~ N(3, 1)."""
    ell = expected_loglik(params, cnt, rsum, sqsum, n_ratings, noise)
    kl = sum(_kl_normal(*params[site], *prior)
             for site, prior in PRIORS.items())
    return kl - ell


def run_dense(cfg: Config, generator=None, data=None, params=None):
    """Train the dense analytic ELBO eagerly (autograd through
    ``dense_neg_elbo``), Adam at a cosine-decayed rate, on ``cfg.device``.
    ``data`` ``(users, items, ratings, truth)`` overrides ``make_data``;
    ``params`` overrides ``dense_init(cfg, generator)``.  Returns the
    RMSE, the final ELBO, the loss trace and the params."""
    if cfg.smoke:
        cfg = dataclasses.replace(cfg, **_SMOKE)
    device = torch.device(cfg.device)
    users, items, ratings, _ = data if data is not None else make_data(cfg)
    cnt, rsum, sqsum, n = dense_stats(users, items, ratings, cfg.num_users,
                                      cfg.num_items, device)
    if params is None:
        params = dense_init(cfg, generator, device=device)
    opt = Adam(cosine_decay_schedule(cfg.lr, cfg.steps))
    state = opt.init(params)
    losses = []
    for _ in range(cfg.steps):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = dense_neg_elbo(p, cnt, rsum, sqsum, n, cfg.noise)
        leaves = [t for site in PRIORS for t in p[site]]
        g = iter(torch.autograd.grad(loss, leaves))
        grads = {site: (next(g), next(g)) for site in PRIORS}
        params, state = opt.update(grads, state, params)
        losses.append(loss.detach())
    losses = torch.stack(losses).cpu().numpy()
    mean_u = {k: v[0] for k, v in params.items()}
    idx = [torch.as_tensor(np.asarray(a), device=device)
           for a in (users, items, ratings)]
    return {
        "rmse": _rmse(mean_u, *idx),
        "noise_floor": cfg.noise,
        "final_elbo": -float(losses[-1]),
        "losses": losses,
        "params": params,
        "opt_state": state,
        "mean": mean_u,
        "std": {k: torch.exp(v[1]) for k, v in params.items()},
    }


# ---------------------------------------------------------------------------
# the item-sharded dense path
# ---------------------------------------------------------------------------

_ITEM_SHARDED = ("v", "bi")     # sites with a leading num_items dimension


def dense_param_specs(mesh, axis="items"):
    """``{site: Sharding}`` for the dense guide params: the item-side
    sites (v, bi) split on their leading dimension over ``axis``, the rest
    replicated (``Sharding(mesh, None)``)."""
    return {site: Sharding(mesh, axis if site in _ITEM_SHARDED else None)
            for site in PRIORS}


def dense_neg_elbo_sharded(mesh, sqsum, n_ratings, noise, axis="items"):
    """``loss_fn(params, cnt_l, rsum_l)``: this rank's term of
    ``dense_neg_elbo``, whose sum over ``axis`` is the whole -ELBO.
    ``cnt_l`` and ``rsum_l`` are the rank's (U, I / P) column slices,
    ``params`` hold the rank's rows of v and bi and the replicated u, bu
    and m.  The term is the local cells' expected log-likelihood with
    sqsum / P and n_ratings / P, the item-side KL, and the replicated KL
    divided by P, summed in ``dense_neg_elbo``'s site order (with one rank
    its bits).  ``dense_value_and_grad_sharded`` sums the terms and the
    replicated sites' gradients."""
    ndev = axis_size(mesh, axis)
    sqsum, n_ratings, noise = float(sqsum), float(n_ratings), float(noise)

    def loss_fn(params, cnt_l, rsum_l):
        ell = expected_loglik(params, cnt_l, rsum_l, sqsum / ndev,
                              n_ratings / ndev, noise)
        kl = sum(_kl_normal(*params[site], *prior)
                 / (1 if site in _ITEM_SHARDED else ndev)
                 for site, prior in PRIORS.items())
        return kl - ell

    return loss_fn


def dense_value_and_grad_sharded(loss_fn, params, cnt_l, rsum_l, mesh,
                                 axis="items"):
    """(-ELBO, gradients) of the item-sharded objective, equal on every
    rank: autograd of this rank's term, then one all-reduce over ``axis``
    of the term and of the replicated sites' gradients (the transpose of
    the JAX package's psum inside ``shard_map``).  The item-side
    gradients stay this rank's."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = loss_fn(p, cnt_l, rsum_l)
    leaves = [t for site in PRIORS for t in p[site]]
    g = iter(torch.autograd.grad(loss, leaves))
    grads = {site: (next(g), next(g)) for site in PRIORS}
    summed = psum({"loss": loss.detach(),
                   **{s: grads[s] for s in PRIORS
                      if s not in _ITEM_SHARDED}}, mesh, axis)
    return summed.pop("loss"), {**grads, **summed}


def run_dense_sharded(cfg: Config, mesh, generator=None, data=None,
                      axis="items"):
    """``run_dense`` over the ranks of ``mesh``'s ``axis``: the same Adam,
    schedule and step count, each rank holding its (U, I / P) column slice
    of cnt and rsum and its rows of v and bi.  ``num_items`` must divide
    by the axis size.  Returns ``run_dense``'s keys; ``params`` and
    ``opt_state`` are this rank's, ``mean`` and ``std`` whole.  ``data``
    (default: ``make_data``, or every row of ``cfg.data_file``) is the
    whole data set on every rank: a rank needs every rating of its
    columns."""
    if cfg.smoke:
        cfg = dataclasses.replace(cfg, **_SMOKE)
    device = torch.device(cfg.device)
    ndev, me = axis_size(mesh, axis), axis_index(mesh, axis)
    start, per = local_slice(cfg.num_items, ndev, me)
    if data is None:
        data = _data_from_file(cfg, shard=False) if cfg.data_file \
            else _synthetic_data(cfg)
    users, items, ratings, _ = data
    users, items, ratings = (np.asarray(a.cpu() if isinstance(a, torch.Tensor)
                                        else a)
                             for a in (users, items, ratings))
    keep = (items >= start) & (items < start + per)
    cnt, rsum, _, _ = dense_stats(users[keep], items[keep] - start,
                                  ratings[keep], cfg.num_users, per, device)
    r64 = ratings.astype(np.float64)
    sqsum, n = float((r64 * r64).sum()), int(r64.shape[0])
    rows = slice(start, start + per)
    specs = dense_param_specs(mesh, axis)
    params = {site: tuple(t[rows] if specs[site].axis else t for t in pair)
              for site, pair in dense_init(cfg, generator,
                                           device=device).items()}
    loss_fn = dense_neg_elbo_sharded(mesh, sqsum, n, cfg.noise, axis)
    opt = Adam(cosine_decay_schedule(cfg.lr, cfg.steps))
    state = opt.init(params)
    losses = []
    for _ in range(cfg.steps):
        loss, grads = dense_value_and_grad_sharded(loss_fn, params, cnt,
                                                   rsum, mesh, axis)
        params, state = opt.update(grads, state, params)
        losses.append(loss)
    losses = torch.stack(losses).cpu().numpy()
    whole = {site: tuple(all_gather(t, mesh, axis) if specs[site].axis
                         else t for t in pair)
             for site, pair in params.items()}
    mean_u = {k: v[0] for k, v in whole.items()}
    idx = [torch.as_tensor(a, device=device) for a in (users, items, ratings)]
    return {
        "rmse": _rmse(mean_u, *idx),
        "noise_floor": cfg.noise,
        "final_elbo": -float(losses[-1]),
        "losses": losses,
        "params": params,
        "opt_state": state,
        "mean": mean_u,
        "std": {k: torch.exp(v[1]) for k, v in whole.items()},
    }


def run(cfg: Config, generator=None):
    """Mini-batch SVI through the DSL on ``cfg.device``; ``generator`` (on
    that device) draws the mini-batches and the guide's noise."""
    if cfg.smoke:
        cfg = dataclasses.replace(cfg, **_SMOKE, batch_size=512)
    device = torch.device(cfg.device)
    gen = generator if generator is not None else \
        torch.Generator(device=device).manual_seed(cfg.seed)
    users, items, ratings, _ = _tensors(cfg)
    if users.shape[0] != cfg.num_ratings:       # a file's own count
        cfg = dataclasses.replace(cfg, num_ratings=int(users.shape[0]))
    svi = SVI(make_model(cfg), MeanFieldGuide,
              Adam(cosine_decay_schedule(cfg.lr, cfg.steps)),
              model_args=(users, items, ratings), device=device)
    if cfg.bench:
        state = svi.init(gen)
        _, dt = timed_steps(lambda s: svi.run(gen, cfg.steps, state=s),
                            state)
        bench_line("elbo_steps_per_s", cfg.steps / dt, "steps/s",
                   model="matrix_fact", ratings=cfg.num_ratings,
                   batch=cfg.batch_size, factors=cfg.num_factors,
                   device=str(device))
    res = svi.run(gen, cfg.steps)
    mean_u, _ = svi.guide.stats(res.params)
    return {
        "rmse": _rmse(mean_u, users, items, ratings),
        "noise_floor": cfg.noise,
        "final_elbo": -float(res.losses[-1]),
        "losses": res.losses.cpu().numpy(),
        "svi": svi,
        "result": res,
        "params": res.params,
    }


def main(argv=None):
    cfg = parse_config(Config, argv)
    print(dump_config(cfg))
    out = run(cfg)
    print(f"train RMSE = {out['rmse']:.4f} (noise floor {out['noise_floor']})")
    print(f"final ELBO = {out['final_elbo']:.1f}")
    dense = run_dense(cfg)
    print(f"dense: train RMSE = {dense['rmse']:.4f}, final ELBO = "
          f"{dense['final_elbo']:.1f}")


if __name__ == "__main__":
    main()
