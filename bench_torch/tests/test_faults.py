"""The rest of a run, with the timed path broken underneath: ``correct``
has to come out false.  Faults: the step that returns its state
unchanged, and the answer altered where it is produced.  (No cell here
has a batch; the exchange fault needs a cell across ranks.)"""

import json
from pathlib import Path

import pytest
import torch

from bench_torch import run

FFT = ["--seconds", "0.3", "--device", "cpu", "--seed", "2147483653"]
SIZES = {"c2c1024.ac": "16,16,16", "c2c1024.natural": "16,32,8"}


def _line(workload, gdims):
    return run.result(["--workload", workload, "--gdims", gdims, *FFT])


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_sound_runs_are_correct(workload):
    assert _line(workload, SIZES[workload])["correct"] is True


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_forward_returning_its_input(monkeypatch, workload):
    from cudecomp_tpu_torch.ops.fft import DistributedFFT

    monkeypatch.setattr(DistributedFFT, "forward",
                        lambda self, x: x.reshape(self.grid.buffer_shape(2))
                        .clone())
    line = _line(workload, SIZES[workload])
    assert line["correct"] is False
    assert line["checks"]["spectrum_rel_l2"]["value"] > 0.1


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_one_spectrum_value_altered(monkeypatch, workload):
    from cudecomp_tpu_torch.ops.fft import DistributedFFT

    orig = DistributedFFT.forward

    def altered(self, x):
        out = orig(self, x)
        i = torch.unravel_index(out.abs().argmax(), out.shape)
        out[i] = -out[i]
        return out

    monkeypatch.setattr(DistributedFFT, "forward", altered)
    line = _line(workload, SIZES[workload])
    assert line["correct"] is False and line["failed"] >= 1


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_inverse_without_its_normalisation(monkeypatch, workload):
    from cudecomp_tpu_torch.ops.fft import DistributedFFT

    orig = DistributedFFT.inverse
    n = 16 * 16 * 16 if workload == "c2c1024.ac" else 16 * 32 * 8
    monkeypatch.setattr(DistributedFFT, "inverse",
                        lambda self, s: orig(self, s) * n)
    line = _line(workload, SIZES[workload])
    assert line["correct"] is False
    assert line["checks"]["roundtrip_max_abs"]["value"] > 1.0


TG = ["--workload", "tg512.rk4", "--gdims", "32,32,32", *FFT]


def test_tg_sound_run_is_correct():
    assert run.result(TG)["correct"] is True


def test_tg_step_returning_its_state(monkeypatch):
    from cudecomp_tpu_torch.models.taylor_green import TaylorGreenSolver

    monkeypatch.setattr(TaylorGreenSolver, "step",
                        lambda self, uh, f, dt: uh.clone())
    line = run.result(TG)
    assert line["correct"] is False
    assert line["checks"]["step_rel_l2"]["value"] == pytest.approx(1.0)


def test_tg_one_state_value_altered(monkeypatch):
    from cudecomp_tpu_torch.models.taylor_green import TaylorGreenSolver

    orig = TaylorGreenSolver.step

    def altered(self, uh, f, dt):
        out = orig(self, uh, f, dt)
        i = torch.unravel_index(out.abs().argmax(), out.shape)
        out[i] = out[i] * 1.01
        return out

    monkeypatch.setattr(TaylorGreenSolver, "step", altered)
    assert run.result(TG)["correct"] is False


def test_tg_half_step(monkeypatch):
    from cudecomp_tpu_torch.models.taylor_green import TaylorGreenSolver

    orig = TaylorGreenSolver.step
    monkeypatch.setattr(TaylorGreenSolver, "step",
                        lambda self, uh, f, dt: orig(self, uh, f, dt / 2))
    assert run.result(TG)["correct"] is False


# -- across ranks: four gloo ranks on the CPU ---------------------------------

BENCH = json.loads((Path(__file__).resolve().parents[2]
                    / "BENCHMARK.json").read_text())
MULTI = sorted(w["name"] for w in BENCH["workloads"] if w["chips"] > 1)
MULTI_SIZE = "16,16,8"


def rank_without_exchange(*args):
    """A rank whose all-to-all leaves every block where it is."""
    from cudecomp_tpu_torch.parallel import collectives

    collectives._all_to_all = lambda blocks, group: blocks.contiguous().clone()
    run._rank_main(*args)


def rank_with_one_value_altered(*args):
    """A rank whose forward flips the sign of its largest spectrum value
    (rank 2 only)."""
    from cudecomp_tpu_torch.ops.fft import DistributedFFT

    orig = DistributedFFT.forward

    def altered(self, x):
        out = orig(self, x)
        if args[0] == 2:
            i = torch.unravel_index(out.abs().argmax(), out.shape)
            out[i] = -out[i]
        return out

    DistributedFFT.forward = altered
    run._rank_main(*args)


def _multi(workload, rank_main=run._rank_main):
    return run.result(["--workload", workload, "--gdims", MULTI_SIZE, *FFT],
                      rank_main=rank_main)


@pytest.mark.parametrize("workload", MULTI)
def test_multi_rank_sound_run_is_correct(workload):
    line = _multi(workload)
    assert line["correct"] is True and line["device"]["count"] == 4


@pytest.mark.parametrize("workload", MULTI)
@pytest.mark.parametrize("fault", [rank_without_exchange,
                                   rank_with_one_value_altered],
                         ids=["exchange_left_out", "value_altered"])
def test_multi_rank_faults(workload, fault):
    assert _multi(workload, fault)["correct"] is False
