"""Faults planted under a cell's timed path, to show that its check comes
out false on them.  Each is a context manager that wraps the program's
entry the job module calls and restores it on exit:

* ``unchanged``: a step (a trainer call, a NUTS transition) returns its
  state unchanged;
* ``half``: half of the batch (rows, chains) is left out, the mean taken
  over the rest;
* ``altered``: an answer is altered where it is produced (the trainer's
  loss, a transition's draw).

The exchange between chips does not exist in a one-chip cell."""

from __future__ import annotations

import contextlib

import torch

KINDS = ("unchanged", "half", "altered")


@contextlib.contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def svi_fused(kind):
    from bayesic_tpu_torch.ops import fused_vae

    def make(train):
        def wrapped(x, params, m, v, *, steps, lr, seed, batch=256, t0=0,
                    **kw):
            if kind == "half":
                return train(x, params, m, v, steps=steps, lr=lr, seed=seed,
                             batch=batch // 2, t0=t0, **kw)
            p, m2, v2, losses = train(x, params, m, v, steps=steps, lr=lr,
                                      seed=seed, batch=batch, t0=t0, **kw)
            if kind == "unchanged":
                return params, m2, v2, losses
            return p, m2, v2, losses * (1.0 + 1e-3)
        return wrapped

    return _patched(fused_vae, "fused_train", make)


def nuts(kind):
    from bayesic_tpu_torch.infer.mcmc.integrators import IntegratorState
    from bayesic_tpu_torch.models import dlgm

    def make(build):
        def wrapped(*args, **kwargs):
            step = build(*args, **kwargs)

            def transition(key, states, step_size, inv_mass):
                new, info = step(key, states, step_size, inv_mass)
                if kind == "unchanged":
                    return states, info
                if kind == "half":
                    h = states.q.shape[0] // 2
                    cat = [torch.cat([a[:h], b[h:]]) for a, b in
                           zip((new.q, new.p, new.pe, new.grad),
                               (states.q, states.p, states.pe, states.grad))]
                    return IntegratorState(*cat), info._replace(
                        accept_prob=torch.cat([info.accept_prob[:h],
                                               info.accept_prob[:h]]))
                q = new.q.clone()
                q[:, 0] += 1e-2
                return new._replace(q=q), info
            return transition
        return wrapped

    return _patched(dlgm, "make_batched_transition", make)


FOR_KIND = {"svi_fused": svi_fused, "nuts": nuts}
