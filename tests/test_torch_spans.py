"""The port's spans (``utils.metrics.named_scope`` at its layer boundaries)
and the benchmark's readers of them (``portbench/metrics``, arithmetic in
``portbench/harness/spans.py``).

With no profiler recording a span is one shared no-op; under one it is a
``record_function`` on the trace.  The CPU tests record the spans of a
small ``MCMC`` run and of a CPU ``fused_train`` call through the
benchmark's own ``trace.record``, and hold each reader to values worked
out by hand on a hand-built ``Trace``.  The ``gpu`` test runs on a card,
from the repository's root with ``python -m pytest tests/test_torch_spans.py
-m gpu --noconftest``."""

from types import SimpleNamespace

import pytest
import torch

from bayesic_tpu_torch.infer.mcmc import MCMC
from bayesic_tpu_torch.ops import fused_vae as fv
from bayesic_tpu_torch.utils import metrics
from portbench.harness import readers, spans, spec, trace

torch.set_num_threads(2)

LAUNCH = "bayesic.ops.fused_vae.launch"
CALL = "bayesic.ops.fused_vae.fused_train"
ENTRY = "bayesic.models.dlgm.local_posterior_mcmc_fused"
DIMS = fv.FusedVAEDims(n=64, d=12, h=16, z=4, b=32)


def test_named_scope_is_a_shared_no_op_without_a_profiler():
    off = metrics.named_scope("bayesic.a")
    assert off is metrics.named_scope("bayesic.b")
    assert not isinstance(off, torch.profiler.record_function)
    with off:
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = metrics.named_scope("bayesic.a")
    assert isinstance(on, torch.profiler.record_function)
    assert metrics.named_scope("bayesic.a") is off


@pytest.mark.parametrize("segmented", [False, True])
def test_mcmc_records_init_warmup_sample_and_each_transition(segmented):
    def pag(q):
        return 0.5 * (q * q).sum(-1), q

    mcmc = MCMC(potential_and_grad=pag, example_q=torch.zeros(3),
                num_warmup=10, num_samples=10, num_chains=4, device="cpu")
    run = (lambda: mcmc.run_segmented(5, warmup_chunk=4, sample_chunk=4)) \
        if segmented else (lambda: mcmc.run(5))
    res, tr = trace.record(torch, run, cuda=False)
    assert res.unconstrained.shape == (4, 10, 3)
    init = spans.named(tr, "bayesic.mcmc.init")
    (warm,) = spans.named(tr, "bayesic.mcmc.warmup")
    (samp,) = spans.named(tr, "bayesic.mcmc.sample")
    trans = spans.named(tr, "bayesic.mcmc.transition")
    assert len(init) == 1 and init[0][1] <= warm[0] <= warm[1] <= samp[0]
    assert len(trans) == 20
    assert len(spans.inside(warm, trans)) == 10
    assert len(spans.inside(samp, trans)) == 10


def _vae_state(device):
    gen = torch.Generator().manual_seed(3)
    shapes = fv.leaf_shapes(DIMS)
    params = {k: 0.3 * torch.randn(shapes[k], generator=gen)
              for k in fv.LEAVES}
    zeros = {k: torch.zeros(shapes[k]) for k in fv.LEAVES}
    x = torch.randn((DIMS.n, DIMS.d), generator=gen)
    to = lambda tree: {k: a.to(device) for k, a in tree.items()}  # noqa
    return x.to(device), to(params), to(zeros), to(zeros)


def test_cpu_fused_train_records_its_span_and_no_launch():
    x, p, m, v = _vae_state("cpu")
    _, tr = trace.record(torch, lambda: fv.fused_train(
        x, p, m, v, steps=4, lr=1e-3, seed=7, batch=DIMS.b), cuda=False)
    assert len(spans.named(tr, CALL)) == 1
    assert not spans.named(tr, LAUNCH)


def _svi_trace():
    """Two calls, in ns.  Call 1: its launch's ops span 160-500 with 20 ns
    idle; call 2 packs at 620-640 before its launch (between calls), then
    700-1000 with 10 ns idle.  Own host time 150 and 100 ns."""
    host = [(100, 400, CALL), (150, 300, LAUNCH),
            (155, 158, "cudaLaunchKernel"),
            (600, 900, CALL), (610, 640, "aten::cat"), (650, 850, LAUNCH)]
    dev = [(160, 170, "pack_kernel"), (180, 250, "row_kernel"),
           (260, 500, "adam_kernel"), (620, 640, "CatArrayBatchedCopy"),
           (700, 750, "row_kernel"), (760, 1000, "adam_kernel")]
    return trace.Trace(dev, host, 1e-6)


def _nuts_trace():
    """Two jobs: entry 0-50 and init 60-80 (70 ns), entry 1000-1030 and
    init 1035-1045 (40 ns).  Warm-up 100-400: transitions 110-150 and
    200-260, a runtime call inside one and one outside (160-170), so 190
    ns own; sampling 400-600: one transition 410-500, runtime calls
    540-545 and 550-590, so 65 ns own.  A transition outside both loops
    does not count."""
    host = [(0, 50, ENTRY), (60, 80, "bayesic.mcmc.init"),
            (100, 400, "bayesic.mcmc.warmup"),
            (110, 150, "bayesic.mcmc.transition"),
            (120, 130, "cudaLaunchKernel"), (155, 180, "aten::mean"),
            (160, 170, "cudaLaunchKernel"),
            (200, 260, "bayesic.mcmc.transition"),
            (400, 600, "bayesic.mcmc.sample"),
            (410, 500, "bayesic.mcmc.transition"),
            (540, 545, "cudaMemcpyAsync"), (550, 590, "cudaStreamSynchronize"),
            (700, 710, "bayesic.mcmc.transition"),
            (1000, 1030, ENTRY), (1035, 1045, "bayesic.mcmc.init")]
    dev = [(120, 400, "dlgm_nuts_kernel")]
    return trace.Trace(dev, host, 1e-6)


CASES = [("idle_in_calls.svi", _svi_trace, 3.0),
         ("wrapper_ms_per_call.svi", _svi_trace, 1.25e-4),
         ("engine_us_per_trans.nuts", _nuts_trace, 0.085),
         ("prelude_ms_per_job.nuts", _nuts_trace, 5.5e-5)]


@pytest.mark.parametrize("metric,make,want", CASES)
def test_reader_gives_the_hand_worked_value(metric, make, want):
    read = spec.Cell.reader(metric)
    tr = make()
    got = read(SimpleNamespace(trace=tr))
    assert got == pytest.approx(want, rel=1e-9)
    if metric == "idle_in_calls.svi":
        assert got <= readers.idle_percent(SimpleNamespace(trace=tr))
    # a trace without the program's spans (the parent's), and no trace
    bare = trace.Trace(tr.device_ops, [h for h in tr.host_ops
                                       if not h[2].startswith("bayesic.")],
                       tr.window_s)
    assert read(SimpleNamespace(trace=bare)) is None
    assert read(SimpleNamespace(trace=None)) is None


@pytest.mark.gpu
def test_card_launch_span_precedes_its_kernels_and_is_no_device_op():
    """On a card, through the benchmark's ``trace.record``: each call's
    ``pack_kernel`` starts after its launch span starts, and no device op
    carries a ``bayesic.`` name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused trainer has no CPU kernel")
    x, p, m, v = _vae_state("cuda")

    def calls():
        state = (p, m, v)
        for i in range(3):
            state = fv.fused_train(x, *state, steps=20, lr=1e-3, seed=7,
                                   batch=DIMS.b, t0=20 * i)[:3]

    _, tr = trace.record(torch, calls)
    launches = spans.named(tr, LAUNCH)
    packs = tr.named(["pack_kernel"])
    assert len(launches) == len(packs) == len(spans.named(tr, CALL)) == 3
    assert all(k[0] > s[0] for s, k in zip(launches, packs))
    assert not [op for op in tr.device_ops if op[2].startswith("bayesic.")]
