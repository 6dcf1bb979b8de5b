"""The port's six examples (``cudecomp_tpu_torch/examples``) on the CPU at
small sizes, each asserting what its JAX original asserts; basic_usage
and checkpoint_restart also on 4 gloo ranks."""

import importlib

import pytest

NAMES = ("basic_usage", "fft_autotune", "checkpoint_restart",
         "heat3d_stencil", "spectral_ops", "ns_projection")


def _main(name, *argv):
    mod = importlib.import_module(f"cudecomp_tpu_torch.examples.{name}")
    mod.main(["--device", "cpu", *argv])


@pytest.mark.parametrize("name", NAMES)
def test_example_one_rank(name, capsys):
    _main(name, "--n", "16")
    out = capsys.readouterr().out
    assert f"{name}: " in out and " s\n" in out


def test_basic_usage_four_ranks(capsys):
    _main("basic_usage", "--n", "16", "--ranks", "4")
    assert "basic_usage: " in capsys.readouterr().out


def test_checkpoint_restart_four_ranks(capsys):
    _main("checkpoint_restart", "--n", "16", "--ranks", "4")
    assert "checkpoint_restart: " in capsys.readouterr().out


def test_examples_default_to_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module("cudecomp_tpu_torch.examples.basic_usage")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(["--n", "8"])
