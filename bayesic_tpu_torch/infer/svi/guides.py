"""Variational guides over a model's unconstrained latent space.

Counterpart of ``bayesic_tpu/infer/svi/guides.py``: mean-field, full-rank
and low-rank-plus-diagonal Gaussians over the flat unconstrained vector,
the amortized ``NeuralGuide`` and the DSL-authored ``TraceGuide``
(``flows.py`` holds the flow guide).  Each guide's ``ctx["eps"]``, when
given, is the noise it uses in place of draws from the generator.
"""

from __future__ import annotations

import math

import torch

from ...dist.transforms import LowerCholeskyTransform

__all__ = ["unraveler", "Guide", "MeanFieldGuide", "FullRankGuide",
           "LowRankGuide", "NeuralGuide", "TraceGuide"]

_LOG_2PI = math.log(2.0 * math.pi)


def unraveler(info):
    """(dim, unravel, ravel) for ``info.unconstrained_shapes``; ``unravel``
    and ``ravel`` keep any leading batch dims of their input."""
    names = list(info.latent_names)
    shapes = [tuple(info.unconstrained_shapes[n]) for n in names]
    sizes = [math.prod(s) for s in shapes]
    offsets = [0]
    for s in sizes:
        offsets.append(offsets[-1] + s)
    dim = offsets[-1]

    def unravel(flat):
        batch = tuple(flat.shape[:-1])
        return {
            n: flat[..., o:o + s].reshape(batch + shape)
            for n, o, s, shape in zip(names, offsets, sizes, shapes)
        }

    def ravel(uparams):
        some = uparams[names[0]]
        batch = tuple(some.shape[:some.dim() - len(shapes[0])])
        return torch.cat(
            [uparams[n].reshape(batch + (s,)) for n, s in zip(names, sizes)],
            dim=-1,
        )

    return dim, unravel, ravel


class Guide:
    """Interface: ``init(generator) -> params``;
    ``sample_and_log_prob(params, generator, sample_shape) -> (uparams dict
    with leading sample dims, logq)``."""

    def init(self, generator):
        raise NotImplementedError

    def sample_and_log_prob(self, params, generator, sample_shape=(),
                            stop_gradient_q=False, ctx=None):
        """``ctx`` (optional dict with keys ``subsample``/``model_args``/
        ``eps``) carries the per-step mini-batch context so amortized guides
        can encode the same batch the model sees; ``eps``, when not None,
        is noise injected in place of draws from ``generator``."""
        raise NotImplementedError


class MeanFieldGuide(Guide):
    """Diagonal Gaussian q(u) = N(loc, diag(exp(log_scale))^2) over the flat
    unconstrained vector (``unraveler`` order)."""

    def __init__(self, info, init_scale=0.1):
        self.dim, self.unravel, self.ravel = unraveler(info)
        self.init_scale = float(init_scale)

    def init(self, generator, loc=None):
        """``loc`` 0 unless given (a flat vector or a dict of sites);
        ``log_scale`` log(init_scale).  Draws nothing; the params land on
        the generator's device."""
        device = generator.device
        if loc is None:
            loc = torch.zeros(self.dim, device=device)
        elif isinstance(loc, dict):
            loc = self.ravel(loc)
        return {"loc": torch.as_tensor(loc, dtype=torch.float32,
                                       device=device),
                "log_scale": torch.full((self.dim,),
                                        math.log(self.init_scale),
                                        device=device)}

    def sample_and_log_prob(self, params, generator, sample_shape=(),
                            stop_gradient_q=False, ctx=None):
        shape = tuple(sample_shape) + (self.dim,)
        eps = (ctx or {}).get("eps")
        if eps is None:
            eps = torch.randn(shape, generator=generator,
                              device=generator.device)
        else:
            eps = eps.expand(shape)
        flat = params["loc"] + torch.exp(params["log_scale"]) * eps
        loc, ls = params["loc"], params["log_scale"]
        if stop_gradient_q:
            loc, ls = loc.detach(), ls.detach()
        z = (flat - loc) * torch.exp(-ls)
        logq = torch.sum(-0.5 * z * z - ls - 0.5 * _LOG_2PI, -1)
        return self.unravel(flat), logq

    def entropy(self, params):
        return torch.sum(params["log_scale"]) \
            + 0.5 * self.dim * (1.0 + _LOG_2PI)

    def stats(self, params):
        """Unconstrained-space posterior mean/std per site."""
        return (self.unravel(params["loc"]),
                self.unravel(torch.exp(params["log_scale"])))


class FullRankGuide(Guide):
    """Full-covariance Gaussian q(u) = N(loc, L L^T) over the flat
    unconstrained vector, L from a packed lower-Cholesky vector with a
    log diagonal (``LowerCholeskyTransform``)."""

    def __init__(self, info, init_scale=0.1):
        self.dim, self.unravel, self.ravel = unraveler(info)
        self.init_scale = float(init_scale)
        self._tril = LowerCholeskyTransform()
        self._nvec = self.dim * (self.dim + 1) // 2

    def init(self, generator, loc=None):
        """``loc`` 0 unless given (a flat vector or a dict of sites); the
        packed L has diagonal log(init_scale) and zeros elsewhere.  Draws
        nothing; the params land on the generator's device."""
        device = generator.device
        if loc is None:
            loc = torch.zeros(self.dim, device=device)
        elif isinstance(loc, dict):
            loc = self.ravel(loc)
        vec = torch.zeros(self._nvec, device=device)
        pos = [k * (k + 1) // 2 + k for k in range(self.dim)]
        vec[pos] = math.log(self.init_scale)
        return {"loc": torch.as_tensor(loc, dtype=torch.float32,
                                       device=device),
                "scale_tril_vec": vec}

    def _chol(self, params):
        return self._tril.forward(params["scale_tril_vec"])

    def sample_and_log_prob(self, params, generator, sample_shape=(),
                            stop_gradient_q=False, ctx=None):
        shape = tuple(sample_shape) + (self.dim,)
        eps = (ctx or {}).get("eps")
        if eps is None:
            eps = torch.randn(shape, generator=generator,
                              device=generator.device)
        else:
            eps = eps.expand(shape)
        flat = params["loc"] + eps @ self._chol(params).T
        loc, vec = params["loc"], params["scale_tril_vec"]
        if stop_gradient_q:
            loc, vec = loc.detach(), vec.detach()
        q_chol = self._tril.forward(vec)
        diff = flat - loc
        z = torch.linalg.solve_triangular(
            q_chol.expand(diff.shape[:-1] + q_chol.shape), diff[..., None],
            upper=False)[..., 0]
        half_logdet = torch.sum(torch.log(torch.diagonal(q_chol)))
        logq = (-0.5 * torch.sum(z * z, -1) - half_logdet
                - 0.5 * self.dim * _LOG_2PI)
        return self.unravel(flat), logq

    def entropy(self, params):
        return torch.sum(torch.log(torch.diagonal(self._chol(params)))) \
            + 0.5 * self.dim * (1.0 + _LOG_2PI)

    def stats(self, params):
        """Unconstrained-space posterior mean/std per site."""
        chol = self._chol(params)
        std = torch.sqrt(torch.sum(chol * chol, -1))
        return self.unravel(params["loc"]), self.unravel(std)

    def covariance(self, params):
        chol = self._chol(params)
        return chol @ chol.T


class LowRankGuide(Guide):
    """Low-rank-plus-diagonal Gaussian q(u) = N(loc, W W^T + diag(d^2)),
    W (dim, rank), d = exp(log_diag): the correlations of ``rank``
    directions at O(dim rank) parameters.

    Density and entropy use the Woodbury identity and the matrix
    determinant lemma with one (rank, rank) Cholesky; no dim x dim matrix
    is formed:

      cap      = I_r + W^T D^{-1} W                (D = diag(d^2))
      logdet S = logdet(cap) + sum log d^2
      S^{-1} x = D^{-1} x - D^{-1} W cap^{-1} W^T D^{-1} x

    The Cholesky is ``cholesky_ex`` (no host sync; NaN where cap is not
    positive definite, as JAX).  ``ctx["eps"]``, when given, is (...,
    dim + rank): the diagonal's noise, then the low-rank part's."""

    def __init__(self, info, rank=2, init_scale=0.1):
        self.dim, self.unravel, self.ravel = unraveler(info)
        self.rank = int(rank)
        if not 0 < self.rank <= self.dim:
            raise ValueError(
                f"rank must be in [1, dim={self.dim}], got {rank}")
        self.init_scale = float(init_scale)

    def init(self, generator, loc=None):
        """``loc`` 0 unless given; ``log_diag`` log(init_scale); W drawn
        N(0, 1) times 0.3 init_scale / sqrt(rank) (W = 0 is a saddle point
        of the ELBO), on the generator's device."""
        device = generator.device
        if loc is None:
            loc = torch.zeros(self.dim, device=device)
        elif isinstance(loc, dict):
            loc = self.ravel(loc)
        w = (0.3 * self.init_scale / math.sqrt(self.rank)) * torch.randn(
            (self.dim, self.rank), generator=generator, device=device)
        return {"loc": torch.as_tensor(loc, dtype=torch.float32,
                                       device=device),
                "w": w,
                "log_diag": torch.full((self.dim,),
                                       math.log(self.init_scale),
                                       device=device)}

    @staticmethod
    def _cap_chol(params):
        """Cholesky of cap = I_r + W^T D^{-1} W (rank x rank), and
        D^{-1} W."""
        w, log_diag = params["w"], params["log_diag"]
        dinv_w = w * torch.exp(-2.0 * log_diag)[:, None]
        cap = torch.eye(w.shape[1], dtype=w.dtype, device=w.device) \
            + w.T @ dinv_w
        return torch.linalg.cholesky_ex(cap).L, dinv_w

    def _log_prob(self, q_params, flat):
        chol, dinv_w = self._cap_chol(q_params)
        log_diag = q_params["log_diag"]
        diff = flat - q_params["loc"]
        # quadratic form by Woodbury: diff^T D^-1 diff - m^T cap^-1 m,
        # m = W^T D^-1 diff
        z2 = torch.sum(diff * diff * torch.exp(-2.0 * log_diag), -1)
        m = diff @ dinv_w
        y = torch.linalg.solve_triangular(
            chol.expand(m.shape[:-1] + chol.shape), m[..., None],
            upper=False)[..., 0]
        quad = z2 - torch.sum(y * y, -1)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol))) \
            + 2.0 * torch.sum(log_diag)
        return -0.5 * (quad + logdet + self.dim * _LOG_2PI)

    def sample_and_log_prob(self, params, generator, sample_shape=(),
                            stop_gradient_q=False, ctx=None):
        shape = tuple(sample_shape)
        eps = (ctx or {}).get("eps")
        if eps is None:
            dtype = params["loc"].dtype
            eps_d = torch.randn(shape + (self.dim,), generator=generator,
                                device=generator.device, dtype=dtype)
            eps_r = torch.randn(shape + (self.rank,), generator=generator,
                                device=generator.device, dtype=dtype)
        else:
            eps = eps.expand(shape + (self.dim + self.rank,))
            eps_d, eps_r = eps[..., :self.dim], eps[..., self.dim:]
        flat = params["loc"] + torch.exp(params["log_diag"]) * eps_d \
            + eps_r @ params["w"].T
        q_params = {k: v.detach() for k, v in params.items()} \
            if stop_gradient_q else params
        return self.unravel(flat), self._log_prob(q_params, flat)

    def entropy(self, params):
        chol, _ = self._cap_chol(params)
        half_logdet = torch.sum(torch.log(torch.diagonal(chol))) \
            + torch.sum(params["log_diag"])
        return half_logdet + 0.5 * self.dim * (1.0 + _LOG_2PI)

    def stats(self, params):
        """Unconstrained-space posterior mean/std per site."""
        var = torch.exp(2.0 * params["log_diag"]) \
            + torch.sum(params["w"] * params["w"], -1)
        return self.unravel(params["loc"]), self.unravel(torch.sqrt(var))

    def covariance(self, params):
        """Dense (dim, dim) covariance (diagnostics and tests only)."""
        w = params["w"]
        return w @ w.T + torch.diag(torch.exp(2.0 * params["log_diag"]))


class NeuralGuide(Guide):
    """Adapter for amortized guides: the user supplies
    ``init_fn(generator) -> params`` and ``sample_fn(params, generator,
    sample_shape, stop_gradient_q, ctx) -> (uparams, logq)`` (typically an
    encoder ``nn.Module`` applied with ``torch.func.functional_call``)."""

    def __init__(self, init_fn, sample_fn):
        self._init_fn = init_fn
        self._sample_fn = sample_fn

    def init(self, generator):
        return self._init_fn(generator)

    def sample_and_log_prob(self, params, generator, sample_shape=(),
                            stop_gradient_q=False, ctx=None):
        return self._sample_fn(params, generator, sample_shape,
                               stop_gradient_q, ctx)


class TraceGuide(Guide):
    """DSL-authored custom guide: any model-like function using ``param``
    sites for its learnables and ``sample`` sites (in constrained space)
    for the model's latents.

    Example::

        def guide():
            loc = param("mu_loc", torch.zeros(()))
            scale = param("mu_scale", torch.tensor(0.1),
                          constraint=constraints.positive)
            sample("mu", dist.Normal(loc, scale))

    The guide's params are unconstrained through ``biject_to`` of each
    site's constraint.  The ELBO works in unconstrained space, so a sampled
    value x is pulled back through the model's bijector T with the
    change-of-variable correction ``log q_u(u) = log q_x(T(u)) +
    log|dT/du|``.  Several particles are independent draws, one replay
    each, from the one generator in turn.  ``device``: where the discovery
    trace draws (None: the first tensor among ``guide_args``, else
    "cuda")."""

    def __init__(self, guide_fn, model_info, guide_args=(),
                 guide_kwargs=None, device=None):
        from ...core import handlers
        from ...core.logjoint import default_device
        from ...dist.transforms import biject_to

        self._handlers = handlers
        self.guide_fn = guide_fn
        self.info = model_info
        self._args = guide_args
        self._kwargs = guide_kwargs or {}
        self.device = default_device(device, guide_args)

        tr = handlers.trace(handlers.seed(
            guide_fn, rng_key=torch.Generator(self.device).manual_seed(0))
        ).get_trace(*self._args, **self._kwargs)
        self.param_transforms = {}
        self.param_init = {}
        latent_sites = []
        for name, site in tr.items():
            if site["type"] == "param":
                t = biject_to(site["constraint"])
                self.param_transforms[name] = t
                self.param_init[name] = t.inverse(
                    torch.as_tensor(site["value"]))
            elif site["type"] == "sample" and not site["is_observed"]:
                latent_sites.append(name)
        missing = set(model_info.latent_names) - set(latent_sites)
        if missing:
            raise ValueError(
                f"guide does not sample model latent site(s): "
                f"{sorted(missing)}")

    def init(self, generator):
        """The unconstrained initial params, on the generator's device."""
        return {k: v.detach().to(generator.device)
                for k, v in self.param_init.items()}

    def _trace(self, params_u, generator, latents=None):
        """The guide's trace with its params at ``params_u`` and, when
        given, its latents substituted by ``latents``."""
        h = self._handlers
        values = {n: self.param_transforms[n].forward(params_u[n])
                  for n in self.param_transforms}
        if latents:
            values.update(latents)
        return h.trace(h.substitute(h.seed(self.guide_fn, rng_key=generator),
                                    data=values)
                       ).get_trace(*self._args, **self._kwargs)

    def log_prob_at(self, params, xs):
        """(unconstrained latents, log q_u) at the constrained latent values
        ``xs`` (a dict over the model's latents), the params at
        ``params``."""
        gen = torch.Generator(self.device).manual_seed(0)
        tr = self._trace(params, gen, latents=xs)
        logq = 0.0
        uparams = {}
        for n in self.info.latent_names:
            site = tr[n]
            t = self.info.transforms[n]
            u = t.inverse(site["value"])
            logq = logq + torch.sum(site["dist"].log_prob(site["value"])) \
                + torch.sum(t.log_det_jacobian(u))
            uparams[n] = u
        return uparams, logq

    def sample_and_log_prob(self, params, generator, sample_shape=(),
                            stop_gradient_q=False, ctx=None):
        q_params = {k: v.detach() for k, v in params.items()} \
            if stop_gradient_q else params

        def one():
            tr = self._trace(params, generator)
            xs = {n: tr[n]["value"] for n in self.info.latent_names}
            # log q at the sampled point, the params stopped under STL
            return self.log_prob_at(q_params, xs)

        shape = tuple(sample_shape)
        if shape == ():
            return one()
        draws = [one() for _ in range(math.prod(shape))]
        us = {n: torch.stack([d[0][n] for d in draws]).reshape(
            shape + tuple(draws[0][0][n].shape))
            for n in self.info.latent_names}
        logq = torch.stack([torch.as_tensor(d[1]) for d in draws])
        return us, logq.reshape(shape)
