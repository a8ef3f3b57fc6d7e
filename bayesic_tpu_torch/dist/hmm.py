"""Hidden Markov model: the marginal likelihood by the forward algorithm.

Counterpart of ``bayesic_tpu/dist/hmm.py``.  The discrete state path is
marginalised inside ``log_prob``, so a model with Markov discrete
structure needs no enumeration.  The forward pass is a Python loop over
the T steps of (K, K) log-sum-exp updates (the JAX package's ``lax.scan``):
a few eager launches a step, host-bound on the card.

Extras beyond ``log_prob``/``sample``: ``posterior_mode`` (Viterbi) and
``posterior_sample`` (forward-filter backward-sample).  The state draws
are argmaxes of logits plus Gumbel noise (``jax.random.categorical``'s
form); ``sample`` and ``posterior_sample`` take that noise, and
``sample`` the emission draws, as inputs, so a JAX draw replays exactly.
"""

from __future__ import annotations

import torch

from .distribution import Distribution, broadcast_shapes

__all__ = ["HiddenMarkovModel"]


def _gumbel(shape, generator, dtype):
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=dtype)
    return -torch.log(-torch.log(u))


class HiddenMarkovModel(Distribution):
    """``HiddenMarkovModel(initial_logits (K,), transition_logits (K, K),
    observation_dist, num_steps)``.

    ``observation_dist`` has batch shape ``(K,)`` (one emission law per
    hidden state) and any event shape E; the HMM's event shape is
    ``(num_steps,) + E``.  Logits are unnormalized (log-softmax applied
    inside), so unconstrained sites can feed them directly.  Batch HMMs:
    construct per instance and ``vmap``."""

    _params = ("initial_logits", "transition_logits", "observation_dist")
    reparametrized = False

    def __init__(self, initial_logits, transition_logits, observation_dist,
                 num_steps):
        initial_logits = torch.as_tensor(initial_logits)
        transition_logits = torch.as_tensor(transition_logits)
        if initial_logits.dim() != 1 or transition_logits.dim() != 2:
            raise ValueError(
                "batched HMMs are not supported directly; vmap over "
                "per-instance constructions instead"
            )
        k = initial_logits.shape[0]
        if tuple(transition_logits.shape) != (k, k):
            raise ValueError(
                f"transition_logits must be ({k}, {k}), got "
                f"{tuple(transition_logits.shape)}"
            )
        if tuple(observation_dist.batch_shape) != (k,):
            raise ValueError(
                f"observation_dist batch shape {observation_dist.batch_shape}"
                f" must be exactly ({k},) — one emission law per state; "
                "extra leading batch dims are not supported (vmap instead)"
            )
        self.initial_logits = initial_logits
        self.transition_logits = transition_logits
        self.observation_dist = observation_dist
        self.num_steps = int(num_steps)
        super().__init__(
            (), (self.num_steps,) + tuple(observation_dist.event_shape))

    @property
    def num_states(self):
        return self.initial_logits.shape[0]

    def expand(self, batch_shape):
        """iid batch of the SAME chain (params shared, not broadcast):
        ``log_prob`` already takes leading batch dims on x; ``sample``
        folds batch_shape into the draw shape."""
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new._batch_shape = broadcast_shapes(self.batch_shape,
                                            tuple(batch_shape))
        return new

    @property
    def support(self):
        return self.observation_dist.support

    # ------------------------------------------------------------------
    def _log_init(self):
        return torch.log_softmax(self.initial_logits, -1)

    def _log_trans(self):
        return torch.log_softmax(self.transition_logits, -1)

    def _obs_lp(self, x):
        """x (..., T, *E) -> per-state emission log-probs (T, ..., K)."""
        ev = len(self.observation_dist.event_shape)
        x_exp = torch.as_tensor(x).unsqueeze(-1 - ev)     # (..., T, 1, *E)
        lp = self.observation_dist.log_prob(x_exp)        # (..., T, K)
        return lp.movedim(-2, 0)

    def _forward(self, x, keep=True):
        """The filtered log alphas (T, ..., K), or the last one alone."""
        lp = self._obs_lp(x)
        log_trans = self._log_trans()
        alpha = self._log_init() + lp[0]
        alphas = [alpha]
        for t in range(1, lp.shape[0]):
            alpha = torch.logsumexp(alpha[..., :, None] + log_trans,
                                    -2) + lp[t]
            if keep:
                alphas.append(alpha)
        return torch.stack(alphas) if keep else alpha

    def log_prob(self, x):
        return torch.logsumexp(self._forward(x, keep=False), -1)

    # ------------------------------------------------------------------
    def sample(self, generator, sample_shape=(), gumbels=None,
               obs_draws=None):
        """States by ancestral categorical draws, emissions drawn for all K
        states and selected by the path.  ``gumbels`` (T, *shape, K), shape
        ``sample_shape + batch_shape``, is the Gumbel noise of each step's
        state draw (``jax.random.categorical``'s, under the JAX package's
        ``fold_in(k_state, t)``), and ``obs_draws`` (T, *shape, K, *E) the
        emission draws; each comes from ``generator`` when not given."""
        shape = tuple(sample_shape) + self.batch_shape
        k = self.num_states
        log_init, log_trans = self._log_init(), self._log_trans()
        if gumbels is None:
            gumbels = _gumbel((self.num_steps,) + shape + (k,), generator,
                              log_init.dtype)
        gumbels = torch.as_tensor(gumbels, device=log_init.device)
        z = torch.argmax(gumbels[0] + log_init, -1)
        zs = [z]
        for t in range(1, self.num_steps):
            z = torch.argmax(gumbels[t] + log_trans[z], -1)
            zs.append(z)
        z = torch.stack(zs)                               # (T, ...)
        if obs_draws is None:
            obs_draws = self.observation_dist.sample(
                generator, (self.num_steps,) + shape)     # (T, ..., K, *E)
        draws = torch.as_tensor(obs_draws, device=log_init.device)
        ev = len(self.observation_dist.event_shape)
        z_idx = z.reshape(tuple(z.shape) + (1,) * (ev + 1)).expand(
            tuple(z.shape) + (1,) + tuple(draws.shape[len(shape) + 2:]))
        x = torch.take_along_dim(draws, z_idx, len(shape) + 1)
        x = x.squeeze(len(shape) + 1)                     # (T, ..., *E)
        return x.movedim(0, len(shape))

    # ------------------------------------------------------------------
    def posterior_mode(self, x):
        """Viterbi MAP state path for observations x (T, *E) -> (T,)."""
        lp = self._obs_lp(x)                              # (T, K)
        log_trans = self._log_trans()
        delta = self._log_init() + lp[0]
        ptrs = []
        for t in range(1, lp.shape[0]):
            scores = delta[:, None] + log_trans           # (K_prev, K)
            ptrs.append(torch.argmax(scores, 0))
            delta = torch.max(scores, 0).values + lp[t]
        z = torch.argmax(delta)
        path = [z]
        for ptr in reversed(ptrs):
            z = ptr[z]
            path.append(z)
        return torch.stack(path[::-1])

    def posterior_sample(self, generator, x, sample_shape=(), gumbels=None):
        """Forward-filter backward-sample: exact joint posterior draws of
        the state path given x (T, *E); returns (*sample_shape, T).
        ``gumbels`` (T, *sample_shape, K) is the noise of step t's draw
        (the JAX package's ``fold_in(key, t)``), else drawn from
        ``generator``."""
        alphas = self._forward(x)                         # (T, K)
        log_trans = self._log_trans()
        shape = tuple(sample_shape)
        if gumbels is None:
            gumbels = _gumbel((self.num_steps,) + shape
                              + (self.num_states,), generator, alphas.dtype)
        gumbels = torch.as_tensor(gumbels, device=alphas.device)
        z = torch.argmax(gumbels[-1] + alphas[-1], -1)
        zs = [z]
        for t in range(self.num_steps - 2, -1, -1):
            logits = alphas[t][:, None] + log_trans       # (K_t, K_{t+1})
            z = torch.argmax(gumbels[t] + logits.T[z], -1)
            zs.append(z)
        z = torch.stack(zs[::-1])                         # (T, ...)
        return z.movedim(0, -1) if shape else z
