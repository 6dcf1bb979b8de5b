"""The port's dryrun (``cudecomp_tpu_torch.dryrun``) against the JAX
package's ``__graft_entry__``: ``entry``'s step on seeded inputs, and the
multi-rank pipeline on 4 CPU ranks running every stage and refusing
none."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from cudecomp_tpu_torch import dryrun


def test_entry_step_matches_jax_entry():
    step, args = dryrun.entry("cpu")
    assert all(a.device.type == "cpu" and a.dtype == torch.float32
               and not a.any() for a in args)
    jstep, jargs = graft.entry()
    rng = np.random.default_rng(11)
    arrays = [rng.standard_normal(a.shape).astype(np.float32) for a in args]
    assert [a.shape for a in arrays] == [tuple(j.shape) for j in jargs]
    got = step(*[torch.from_numpy(a) for a in arrays])
    want = jax.jit(jstep)(*[jax.device_put(a, j.sharding)
                            for a, j in zip(arrays, jargs)])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))
    # the inputs are left as they were (the halo update takes a copy)
    assert np.array_equal(arrays[1], args[1].numpy()) or not args[1].any()


def test_entry_seeded_args_and_cuda_default(monkeypatch):
    _, a = dryrun.entry("cpu", seed=3)
    _, b = dryrun.entry("cpu", seed=3)
    assert all(torch.equal(x, y) and x.any() for x, y in zip(a, b))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        dryrun.dryrun_multichip(2, "meta")


def test_dryrun_multichip_four_cpu_ranks_runs_everything():
    reports = dryrun.dryrun_multichip(4, "cpu", timeout=300)
    assert [r["rank"] for r in reports] == [0, 1, 2, 3]
    want = ["all_to_all", "ring", "ring_xor", "ring_pipelined", "ring_hier",
            "pallas_a2a", "halo_ppermute", "halo_pallas", "fft_c2c",
            "fft_r2c", "spectral", "diffusion_step_halo_map", "uneven",
            "uneven_ring", "projection_step", "autotune", "autotune_fft",
            "checkpoint", "finalize"]
    for r in reports:
        assert r["refused"] == {} and r["ran"] == want, r
        assert r["pdims"] == [2, 2] and r["device"] == "cpu"
