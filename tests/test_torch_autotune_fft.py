"""``autotune_fft`` of the port: the gate-then-pick protocol of
``cudecomp_tpu.ops.fft.autotune_fft`` over the port's one FFT plan policy,
``DistributedFFT.fused2`` (K5 for the (1, 2) pair, or cuFFT alone)."""

import jax
import numpy as np
import pytest
import torch

import cudecomp_tpu as cd
from cudecomp_tpu.ops.fft import DistributedFFT as JFFT

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch import performance
from cudecomp_tpu_torch.config import CannotRun
from cudecomp_tpu_torch.ops import fft as F
from cudecomp_tpu_torch.utils.testing import protocol_worker, run_ranks

FAST = dict(n_warmup=0, n_trials=2, iters=1)


def _grid(gdims=(4, 8, 128), **kw):
    return ct.make_grid(ct.GridConfig(gdims=gdims, pdims=(1, 1), **kw),
                        "cpu")


def _fake_times(monkeypatch, by_policy):
    """time_fn returning ``by_policy[fused2]`` seconds for each trial, and
    the policies it was asked to time."""
    timed = []

    def fake(fn, *args, n_warmup=3, n_trials=5, iters=1, device=None):
        plan = fn.__defaults__[0]
        timed.append(plan.fused2)
        assert device == torch.device("cpu") and iters == FAST["iters"]
        return [by_policy[plan.fused2]] * n_trials

    monkeypatch.setattr(performance, "time_fn", fake)
    return timed


def test_candidates_are_cufft_then_k5():
    res = ct.autotune_fft(_grid(), **FAST)
    assert [t.fused2 for t in res.trials] == [False, True]
    assert all(t.gate_passed and t.reason is None and len(t.times_s) == 2
               for t in res.trials)
    assert all(t.err < 5e-4 for t in res.trials)
    assert res.plan.fused2 in (False, True) and res.plan.split_complex
    assert res.best_time_s == min(t.avg_s for t in res.trials)
    assert ct.fft.autotune_fft is ct.autotune_fft
    assert "autotune_fft" in ct.__all__ and "fft" in ct.__all__


def test_gate_failure_is_not_timed(monkeypatch):
    timed = _fake_times(monkeypatch, {False: 2.0, True: 1.0})
    real_dft2 = F.dft2
    # K5's candidate returns a result 1e-3 off: its gate fails
    monkeypatch.setattr(F, "dft2", lambda x, inverse=False:
                        real_dft2(x, inverse) + 1e-3)
    res = ct.autotune_fft(_grid(), **FAST)
    assert timed == [False]
    k5 = res.trials[1]
    assert not k5.gate_passed and k5.times_s == () and k5.avg_s == np.inf
    assert k5.err > 5e-4 and k5.reason is None
    assert res.plan.fused2 is False and res.best_time_s == 2.0


def test_all_failing_raises_naming_each():
    with pytest.raises(RuntimeError) as e:
        ct.autotune_fft(_grid(), gate=0.0, **FAST)
    msg = str(e.value)
    assert "(fused2=0) err=" in msg and "(fused2=1) err=" in msg
    assert "0 round-trip gate" in msg
    with pytest.raises(RuntimeError, match=r"\(fused2=1\) not run: no 3D"):
        ct.autotune_fft(_grid((4, 8, 12)), candidates=(True,), **FAST)


def test_k5_candidate_refused_off_the_gate():
    for grid in (_grid((4, 8, 12)), _grid((4, 12, 128)),
                 _grid((4, 8, 512)), _grid((8, 128, 4),
                                           transpose_axis_contiguous=(
                                               True, True, True))):
        res = ct.autotune_fft(grid, **FAST)
        k5 = res.trials[1]
        assert k5.fused2 and not k5.gate_passed and k5.times_s == ()
        assert "K5's gate" in k5.reason and k5.err == np.inf
        assert res.plan.fused2 is False
    plan = F.DistributedFFT(grid=_grid(), fused2=True)
    with pytest.raises(CannotRun, match="split_complex"):
        F._k5_stage(plan)


def test_winner_is_pinned_into_the_plan(monkeypatch):
    _fake_times(monkeypatch, {False: 2.0, True: 0.5})
    calls = []
    real_dft2 = F.dft2

    def spy(x, inverse=False):
        calls.append(inverse)
        return real_dft2(x, inverse)

    monkeypatch.setattr(F, "dft2", spy)
    res = ct.autotune_fft(_grid(), **FAST)
    assert res.plan.fused2 is True and res.best_time_s == 0.5
    calls.clear()
    monkeypatch.setenv("CUDECOMP_TPU_FFT_FUSED2", "0")  # the plan pins it
    x = torch.randn((4, 8, 128, 2))
    res.plan.forward(x)
    assert calls == [False]
    calls.clear()
    F.DistributedFFT(grid=res.plan.grid, split_complex=True).forward(x)
    assert calls == []  # fused2=None follows the environment
    monkeypatch.setenv("CUDECOMP_TPU_FFT_FUSED2", "1")
    F.DistributedFFT(grid=res.plan.grid, split_complex=True).forward(x)
    assert calls == [False]
    calls.clear()
    F.DistributedFFT(grid=res.plan.grid, split_complex=True,
                     fused2=False).forward(x)
    assert calls == []


def test_report_lines(monkeypatch):
    _fake_times(monkeypatch, {False: 0.25, True: 0.125})
    res = ct.autotune_fft(_grid(), **FAST)
    lines = res.report().splitlines()
    assert lines[0] == "CUDECOMP_TPU: FFT plan autotune (avg s | gate):"
    assert lines[1].startswith("  fused2=0 0.250000 | err ")
    assert lines[1].endswith(" PASS")
    assert lines[2].startswith("  fused2=1 0.125000 | err ")
    assert lines[3] == "  -> selected fused2=1 (0.125000 s)"
    res = ct.autotune_fft(_grid((4, 8, 12)), **FAST)
    assert res.report().splitlines()[2].startswith(
        "  fused2=1 not run: no 3D FFT stage")


def test_gate_data_stays_on_a_cpu_grid(monkeypatch):
    def no_cuda(*a, **k):
        raise AssertionError("a CUDA call on a CPU grid")

    for name in ("synchronize", "current_device", "Event",
                 "current_stream"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    made = []
    gen_cls = torch.Generator

    def gen(device="cpu"):
        made.append(torch.device(device))
        return gen_cls(device=device)

    monkeypatch.setattr(torch, "Generator", gen)
    res = ct.autotune_fft(_grid((4, 8, 12)), real=True, seed=3, **FAST)
    assert made == [torch.device("cpu")]
    assert res.trials[0].gate_passed


@pytest.mark.parametrize("real", [False, True])
def test_winner_forward_matches_jax(real):
    gdims = (6, 8, 128)
    res = ct.autotune_fft(_grid(gdims), real=real, **FAST)
    jgrid = cd.make_grid(cd.GridConfig(gdims=gdims, pdims=(1, 1)),
                         devices=jax.devices()[:1])
    jplan = JFFT(grid=jgrid, real=real, split_complex=True)
    rng = np.random.default_rng(8)
    f = rng.standard_normal(gdims)
    for fused2 in (False, True):  # whichever wins, both policies agree
        plan = F.DistributedFFT(grid=res.plan.grid, real=real,
                                split_complex=True, fused2=fused2)
        if real:
            got = plan.forward_planes(torch.from_numpy(f))
            want = jplan.forward_planes(jax.numpy.asarray(f))
        else:
            g = rng.standard_normal(gdims)
            got = plan.forward_planes((torch.from_numpy(f),
                                       torch.from_numpy(g)))
            want = jplan.forward_planes((jax.numpy.asarray(f),
                                         jax.numpy.asarray(g)))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-10)


def test_four_gloo_ranks_pick_alike(tmp_path):
    run_ranks(protocol_worker, 4,
              (4, str(tmp_path / "pg_init"), ["autotune_fft"]), 240,
              "the 4-rank autotune_fft run")
