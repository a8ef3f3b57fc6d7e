"""MCMC: warmup with Stan windows, then sampling, all chains at once.

Counterpart of ``bayesic_tpu/infer/mcmc/mcmc.py``.  JAX compiles warmup and
sampling into two scans over a vmapped kernel; here both are Python loops
over transitions, and each transition advances every chain in one batched
call (the chain axis is the leading axis of every state tensor).  Every
per-chain draw comes from a stream keyed by ``(seed, phase, t, chain)``
(``streams.py``), so a chain's samples do not depend on how many chains
run beside it, nor on which rank runs it: with ``chain_sharding`` each rank
of a mesh axis runs its contiguous share of the chains by their global
indices, and pooled adaptation gathers every chain's statistics before it
reduces them as one process would.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ...core.logjoint import build_logjoint, default_device, init_to_uniform
from ...parallel.mesh import all_gather, axis_index, axis_size, local_slice
from ...utils import diagnostics as diag
from ..svi.guides import unraveler
from .adapt import (
    build_schedule,
    da_init,
    da_update,
    welford_finalize,
    welford_init,
    welford_update,
    welford_update_batch,
)
from .hmc import make_hmc_kernel
from .integrators import IntegratorState
from .nuts import make_nuts_kernel
from .streams import INIT, SAMPLE, WARMUP, StreamKey, init_uniforms, \
    nuts_streams

__all__ = ["MCMC", "MCMCResult", "gather_chains"]

_PER_CHAIN = ("diverging", "accept_prob", "tree_depth", "num_steps")


class MCMCResult(NamedTuple):
    samples: dict                # site -> (chains, samples, *event)
    extra: dict                  # diverging, accept_prob, tree_depth, ...
    unconstrained: torch.Tensor  # (chains, samples, dim)
    chains: Any = None           # (chains,) global indices of the rows


def gather_chains(result: MCMCResult, chain_sharding) -> MCMCResult:
    """Every rank's chains of a chain-sharded run, in global order, on
    every rank (an all_gather of each per-chain array; the per-chain step
    sizes and masses too when adaptation was per chain).  For diagnostics
    and tests: a run at scale keeps its chains where they ran."""
    mesh, axis = chain_sharding

    def g(x):
        return all_gather(x, mesh, axis)

    per_chain = set(_PER_CHAIN)
    if result.extra["step_size"].dim() == 1:     # per-chain adaptation
        per_chain |= {"step_size", "inv_mass"}
    extra = {k: g(v) if k in per_chain else v
             for k, v in result.extra.items()}
    return MCMCResult({k: g(v) for k, v in result.samples.items()}, extra,
                      g(result.unconstrained), g(result.chains))


class _WarmupCarry(NamedTuple):
    state: IntegratorState   # batched over chains
    da: Any
    wf: Any
    inv_mass: torch.Tensor
    step_size: torch.Tensor


class MCMC:
    """NUTS/HMC sampler: multinomial NUTS with dual-averaging step size and
    windowed Welford (diag or dense) mass adaptation, divergence
    accounting, many chains in lockstep.

    ``potential_and_grad`` (when no ``model`` is given) is batched:
    ``q (C, D) -> (pe (C,), grad (C, D))``.  ``device`` is where the chains
    live; ``None`` means the device of the first tensor among
    ``model_args``, ``init_params`` and ``example_q``, or ``"cuda"`` if
    there is none.  ``batched_transition``, when given, replaces the kernel:
    ``(key, states, step_size, inv_mass) -> (states, NUTSInfo)`` on all
    chains, where ``key`` is the transition's ``streams.StreamKey`` from
    which it draws its own per-chain streams.

    ``chain_sharding`` (a ``parallel.mesh.Sharding`` or ``(mesh, axis)``)
    splits the ``num_chains`` chains over a mesh axis of S ranks: this
    rank runs ``num_chains / S`` of them, global indices ``rank * C / S +
    i``, and its result holds those (``MCMCResult.chains``;
    ``gather_chains`` collects every rank's).  Under ``shared_adapt`` each
    warmup step all-gathers the chains' accept probabilities (and in the
    slow windows their positions), so the step size and the mass are the
    unsharded run's bits; per-chain adaptation needs no collective.  A
    ``batched_transition`` must then run the rank's chains by their global
    indices (``make_batched_transition(chain0=)``).
    """

    def __init__(self, model=None, *, potential_and_grad=None, example_q=None,
                 constrain=None,
                 kernel="nuts", num_warmup=1000, num_samples=1000,
                 num_chains=4, max_depth=10, target_accept=0.8,
                 dense_mass=False, init_step_size=0.1, thin=1,
                 hmc_num_steps=32, model_args=(), model_kwargs=None,
                 shared_adapt=False, init_params=None,
                 batched_transition=None, chain_sharding=None, device=None):
        self.num_warmup = int(num_warmup)
        self.num_samples = int(num_samples)
        self.num_chains = int(num_chains)
        self.thin = int(thin)
        self.target_accept = float(target_accept)
        self.dense_mass = bool(dense_mass)
        self.init_step_size = float(init_step_size)
        self.device = default_device(device, model_args, init_params,
                                     example_q)
        # pooled cross-chain adaptation: one step size and one mass matrix
        # fed by every chain's statistics (the regime for 100s of chains)
        self.shared_adapt = bool(shared_adapt)
        self.init_params = (
            None if init_params is None
            else torch.as_tensor(init_params, dtype=torch.float32,
                                 device=self.device)
        )
        self.chain_sharding = chain_sharding
        start, self._n = 0, self.num_chains
        if chain_sharding is not None:
            mesh, axis = chain_sharding
            start, self._n = local_slice(self.num_chains,
                                         axis_size(mesh, axis),
                                         axis_index(mesh, axis))
        self._start, self._chains = start, None
        self.batched_transition = batched_transition
        if batched_transition is not None and not self.shared_adapt:
            raise ValueError(
                "batched_transition requires shared_adapt=True (the "
                "fused transition consumes one scalar step size and one "
                "shared inverse mass)")

        if model is not None:
            # the discovery trace draws on the chains' device
            info, logdensity, constrain_fn, _ = build_logjoint(
                model, *model_args,
                rng_key=torch.Generator(device=self.device).manual_seed(0),
                **(model_kwargs or {}))
            dim, unravel_fn, ravel_fn = unraveler(info)
            self.info = info
            self.dim = dim
            self._ravel = ravel_fn
            value_and_grad = torch.func.vmap(torch.func.grad_and_value(
                lambda qq: -logdensity(unravel_fn(qq))))

            def pag(q):
                grad, pe = value_and_grad(q)
                return pe, grad

            self._potential_and_grad = pag
            self._constrain = lambda q: constrain_fn(unravel_fn(q))
        else:
            if potential_and_grad is None or example_q is None:
                raise ValueError(
                    "pass either model= or (potential_and_grad=, example_q=)"
                )
            self.info = None
            self.dim = int(torch.as_tensor(example_q).numel())
            self._potential_and_grad = potential_and_grad
            self._constrain = constrain or (lambda q: {"q": q})

        if self.init_params is not None and tuple(self.init_params.shape) \
                != (self.num_chains, self.dim):
            raise ValueError(
                f"init_params must be (num_chains, dim) = "
                f"({self.num_chains}, {self.dim}); got "
                f"{tuple(self.init_params.shape)}.  Rows must be "
                "UNCONSTRAINED-space points, one per chain."
            )
        if self.init_params is not None:
            self.init_params = self.init_params[start:start + self._n]

        if kernel == "nuts":
            self._kernel = make_nuts_kernel(
                self._potential_and_grad, max_depth=max_depth,
                dense=self.dense_mass)
            self._depth = int(max_depth)
        elif kernel == "hmc":
            self._kernel = make_hmc_kernel(
                self._potential_and_grad, num_steps=hmc_num_steps,
                dense=self.dense_mass)
            self._depth = 1      # one accept uniform per transition
        else:
            raise ValueError(f"unknown kernel {kernel!r}")
        self._schedule = build_schedule(self.num_warmup)

    @property
    def chains(self):
        """Global indices of the chains this process runs, on the chains'
        device (made at first use: a card need not exist before a run)."""
        if self._chains is None:
            self._chains = torch.arange(self._start, self._start + self._n,
                                        device=self.device)
        return self._chains

    # ------------------------------------------------------------------
    def _init_states(self, seed):
        if self.init_params is not None:
            q = self.init_params
        else:
            u = init_uniforms(StreamKey(seed, INIT, 0), self.chains,
                              self.dim, self.device)
            q = -2.0 + 4.0 * u if self.info is None else \
                self._ravel(init_to_uniform(self.info, uniforms=u))
        pe, grad = self._potential_and_grad(q)
        return IntegratorState(q, torch.zeros_like(q), pe, grad)

    def _initial_mass(self):
        if self.dense_mass:
            return torch.eye(self.dim, device=self.device)
        return torch.ones(self.dim, device=self.device)

    def _welford_init(self):
        batch = () if self.shared_adapt else (self._n,)
        return welford_init(self.dim, dense=self.dense_mass, batch=batch,
                            device=self.device)

    def _initial_carry(self, seed):
        states = self._init_states(seed)
        mass = self._initial_mass()
        if self.shared_adapt:
            step0 = torch.tensor(self.init_step_size, device=self.device)
        else:
            mass = mass.expand((self._n,) + mass.shape).clone()
            step0 = torch.full((self._n,), self.init_step_size,
                               device=self.device)
        return _WarmupCarry(states, da_init(step0), self._welford_init(),
                            mass, step0)

    # ------------------------------------------------------------------
    def _transition(self, key, state, step_size, inv_mass):
        """One transition of every chain: the batched override (the fused
        kernel path) when set, else the kernel on streams drawn here."""
        if self.batched_transition is not None:
            return self.batched_transition(key, state, step_size, inv_mass)
        streams = nuts_streams(key, self.chains, self.dim, self._depth,
                               self.device)
        return self._kernel(streams, state, step_size, inv_mass)

    def _pooled(self, x):
        """Every chain's rows of ``x``, in global chain order: gathered
        over the chain axis when sharded."""
        if self.chain_sharding is None:
            return x
        return all_gather(x, *self.chain_sharding)

    def _warm_step(self, seed, carry: _WarmupCarry, t):
        in_slow, window_end = self._schedule
        eps = torch.exp(carry.da.log_step)
        state, info = self._transition(StreamKey(seed, WARMUP, t),
                                       carry.state, eps, carry.inv_mass)
        if self.shared_adapt:
            da = da_update(carry.da,
                           torch.mean(self._pooled(info.accept_prob)),
                           target=self.target_accept)
        else:
            da = da_update(carry.da, info.accept_prob,
                           target=self.target_accept)
        wf, inv_mass = carry.wf, carry.inv_mass
        if in_slow[t]:
            wf = welford_update_batch(wf, self._pooled(state.q)) \
                if self.shared_adapt else welford_update(wf, state.q)
        if window_end[t]:
            inv_mass = welford_finalize(wf)
            wf = self._welford_init()
            da = da_init(torch.exp(da.log_step))
        return _WarmupCarry(state, da, wf, inv_mass, torch.exp(da.log_step))

    def _sample_step(self, seed, state, step_size, inv_mass, t):
        # in-loop thinning: `thin` transitions per kept sample
        for i in range(self.thin):
            state, info = self._transition(
                StreamKey(seed, SAMPLE, t * self.thin + i), state, step_size,
                inv_mass)
        depth = getattr(info, "depth", None)
        if depth is None:
            depth = torch.zeros_like(info.diverging, dtype=torch.int32)
        return state, (state.q, info.diverging, info.accept_prob, depth,
                       info.num_steps)

    def _warmup(self, seed, carry, lo, hi):
        for t in range(lo, hi):
            carry = self._warm_step(seed, carry, t)
        return carry

    def run(self, seed) -> MCMCResult:
        """Warmup then sampling from the integer ``seed``."""
        return self.run_segmented(seed, self.num_warmup or 1,
                                  self.num_samples or 1,
                                  fence=lambda _: None, to_host=False)

    def run_segmented(self, seed, warmup_chunk=100, sample_chunk=100,
                      fence=None, to_host=True) -> MCMCResult:
        """Warmup and sampling in chunks of transitions with a fence after
        each, numerically identical to :meth:`run` (streams are keyed by
        absolute step).  ``fence(tensor)`` defaults to a host copy of a
        value that depends on the whole chunk; with ``to_host`` the kept
        samples move to the host chunk by chunk, which bounds device memory
        at many chains."""
        if fence is None:
            def fence(leaf):
                return leaf.cpu()

        carry = self._initial_carry(seed)
        for lo in range(0, self.num_warmup, warmup_chunk):
            carry = self._warmup(seed, carry,
                                 lo, min(lo + warmup_chunk, self.num_warmup))
            fence(carry.step_size)

        step_size = torch.exp(carry.da.log_step_avg)
        state, inv_mass = carry.state, carry.inv_mass
        chunks = []
        for lo in range(0, self.num_samples, sample_chunk):
            coll = []
            for t in range(lo, min(lo + sample_chunk, self.num_samples)):
                state, kept = self._sample_step(seed, state, step_size,
                                                inv_mass, t)
                coll.append(kept)
            coll = [torch.stack(a) for a in zip(*coll)]
            fence(coll[0])
            chunks.append([a.cpu() for a in coll] if to_host else coll)
        cat = [torch.cat([c[i] for c in chunks]) for i in range(5)]
        return self._package(*cat, step_size, inv_mass)

    def _package(self, qs, divs, accs, depths, nsteps, step_size,
                 inv_mass) -> MCMCResult:
        # qs: (num_samples, chains, dim) -> (chains, num_samples, dim)
        qs = qs.transpose(0, 1)
        cons = self._constrain(qs.reshape(-1, self.dim))
        samples = {
            name: v.reshape(tuple(qs.shape[:2]) + tuple(v.shape[1:]))
            for name, v in cons.items()
        }
        extra = {
            "diverging": divs.transpose(0, 1),
            "accept_prob": accs.transpose(0, 1),
            "tree_depth": depths.transpose(0, 1),
            "num_steps": nsteps.transpose(0, 1),
            "step_size": step_size,
            "inv_mass": inv_mass,
        }
        return MCMCResult(samples, extra, qs, self.chains)

    # ------------------------------------------------------------------
    @staticmethod
    def summary(result: MCMCResult):
        return diag.summary(result.samples)
