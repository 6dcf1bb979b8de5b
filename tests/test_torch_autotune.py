"""The autotuner of cudecomp_tpu_torch against cudecomp_tpu's: the pieces
that decide (candidate grids, trial payloads, the two-tier schedule and its
host groups, the knobs, the saved result) on the same inputs, and the
protocol (``tests/test_autotune.py``'s cases) on 4 gloo ranks."""

import dataclasses
import importlib
import types

import jax
import numpy as np
import pytest
import torch

import cudecomp_tpu as cd
from cudecomp_tpu.parallel import collectives as jcoll
from cudecomp_tpu.parallel import mesh as jmesh
from cudecomp_tpu.utils import env as jenv

import cudecomp_tpu_torch as ct
from cudecomp_tpu_torch.parallel import collectives as tcoll
from cudecomp_tpu_torch.parallel import mesh as tmesh
from cudecomp_tpu_torch.utils import env as tenv
from cudecomp_tpu_torch.utils.testing import protocol_worker, run_ranks

jat = importlib.import_module("cudecomp_tpu.autotune")
tat = importlib.import_module("cudecomp_tpu_torch.autotune")


@pytest.mark.parametrize("n", range(1, 17))
def test_hier_schedule_matches_jax(n):
    for g in range(0, n + 2):
        assert tcoll.hier_schedule(n, g) == jcoll.hier_schedule(n, g)


class _FakeMesh:
    """The two attributes of a DeviceMesh that axis_group_size reads."""

    def __init__(self, ranks):
        self.mesh = ranks
        self.mesh_dim_names = ("pr", "pc")


@pytest.mark.parametrize("world", (2, 4, 6, 8, 12, 16))
def test_axis_group_size_matches_jax_slices(world):
    # hosts by rank against TPU slices by device: the same group sizes
    patterns = [tuple(r // k for r in range(world))
                for k in range(1, world + 1) if world % k == 0]
    patterns.append(tuple(int(r >= 1) for r in range(world)))  # irregular
    patterns.append(tuple(r % 2 for r in range(world)))        # interleaved
    for pr, pc in ct.geometry.pdim_candidates(world):
        for order in ct.RankOrder:
            ranks = tmesh.mesh_ranks((pr, pc), order)
            for hosts in patterns:
                fake = _FakeMesh(ranks)
                names = tuple(f"h{h}" for h in hosts)
                devs = np.empty((pr, pc), dtype=object)
                for i in range(pr):
                    for j in range(pc):
                        devs[i, j] = types.SimpleNamespace(
                            platform="tpu",
                            slice_index=hosts[int(ranks[i, j])])
                jfake = types.SimpleNamespace(axis_names=("pr", "pc"),
                                              devices=devs)
                for name in ("pr", "pc"):
                    assert (tmesh.axis_group_size(fake, name, names)
                            == jmesh.axis_group_size(jfake, name)), (
                        (pr, pc), order, hosts, name)
    # a grid whose hosts are unknown runs the flat ring
    assert tmesh.axis_group_size(_FakeMesh(torch.arange(4).reshape(1, 4)),
                                 "pc", None) == 4


@pytest.mark.parametrize("gdims", [(16, 16, 16), (36, 36, 36), (2, 2, 64),
                                   (66, 70, 74), (5, 64, 7), (32, 12, 9)])
def test_valid_pdims_matches_jax(gdims, monkeypatch):
    for gdims_dist in (None, tuple(max(1, g - 3) for g in gdims)):
        jcfg = cd.GridConfig(gdims=gdims, gdims_dist=gdims_dist)
        tcfg = ct.GridConfig(gdims=gdims, gdims_dist=gdims_dist)
        for uneven in (True, False):
            for pr_range, pc_range in ((None, None), ((2, 4), (2, 4)),
                                       ((1, 1), None), (None, (3, 16))):
                kw = dict(allow_uneven_decompositions=uneven,
                          pr_range=pr_range, pc_range=pc_range)
                for nranks in range(1, 17):
                    assert tat._valid_pdims(
                        tcfg, nranks, ct.AutotuneOptions(**kw)) == \
                        jat._valid_pdims(jcfg, nranks,
                                         cd.AutotuneOptions(**kw)), (
                        nranks, kw)
    # the range knobs, read as JAX reads them
    monkeypatch.setenv("CUDECOMP_TPU_AUTOTUNE_P_ROW_RANGE", "2,4")
    monkeypatch.setenv("CUDECOMP_TPU_AUTOTUNE_P_COL_RANGE", "bogus")
    for nranks in (4, 8, 16):
        assert tat._valid_pdims(ct.GridConfig(gdims=gdims), nranks,
                                ct.AutotuneOptions()) == jat._valid_pdims(
            cd.GridConfig(gdims=gdims), nranks, cd.AutotuneOptions())


_HE, _PAD = (1, 2, 0), (0, 1, 3)
_PAYLOADS = [
    {},
    dict(transpose_input_halo_extents=(_HE,) * 4,
         transpose_output_halo_extents=(_HE,) * 4),
    dict(transpose_input_padding=(_PAD,) * 4,
         transpose_output_padding=(_PAD,) * 4),
    dict(transpose_input_halo_extents=((1, 1, 1), (2, 2, 2), (0, 0, 1),
                                       (3, 0, 0)),
         transpose_output_halo_extents=((2, 2, 2), (0, 0, 1), (3, 0, 0),
                                        (1, 1, 1)),
         transpose_input_padding=(_PAD,) * 4,
         transpose_output_padding=(_PAD,) * 4),
    # bad chains
    dict(transpose_input_halo_extents=(_HE,) * 4),
    dict(transpose_output_padding=(_PAD,) * 4),
    dict(transpose_input_halo_extents=(_HE,) * 4,
         transpose_output_halo_extents=(_HE, _HE, _PAD, _HE)),
]


@pytest.mark.parametrize("payload", range(len(_PAYLOADS)))
def test_trial_op_kwargs_match_jax(payload):
    kw = _PAYLOADS[payload]
    try:
        want = jat._trial_op_kwargs(cd.AutotuneOptions(**kw))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tat._trial_op_kwargs(ct.AutotuneOptions(**kw))
        assert str(got.value) == str(e)
        return
    assert tat._trial_op_kwargs(ct.AutotuneOptions(**kw)) == want


def test_autotune_options_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(cd.AutotuneOptions)}
    tf = {f.name: f.default for f in dataclasses.fields(ct.AutotuneOptions)}
    assert list(tf) == list(jf) and tf == jf
    bad = [dict(grid_mode="bogus"), dict(transpose_op_weights=(1.0, 2.0)),
           dict(transpose_input_halo_extents=((1, 1, 1),)),
           dict(transpose_input_halo_extents=(1, 1, 1)),
           dict(halo_padding=(1, 2)), dict(halo_extents=(1, 1)),
           dict(halo_periods=(True,))]
    for kw in bad:
        with pytest.raises(ValueError) as j:
            cd.AutotuneOptions(**kw)
        with pytest.raises(ValueError) as t:
            ct.AutotuneOptions(**kw)
        assert str(t.value) == str(j.value), kw


@pytest.mark.parametrize("spec", ["", "ring,all_to_all", "^ring_xor",
                                  "RING_PIPELINED,^ring", "^all_to_all,^ring,"
                                  "^ring_xor,^ring_pipelined", "bogus",
                                  " , "])
def test_filter_candidates_matches_jax(spec, monkeypatch):
    monkeypatch.setenv("CUDECOMP_TPU_AUTOTUNE_TRANSPOSE_METHODS", spec)
    pool = [m for m in cd.TransposeMethod if m.value != "pallas_a2a"]
    want = jenv.filter_candidates("CUDECOMP_TPU_AUTOTUNE_TRANSPOSE_METHODS",
                                  pool)
    got = tenv.filter_candidates("CUDECOMP_TPU_AUTOTUNE_TRANSPOSE_METHODS",
                                 [ct.TransposeMethod(m.value) for m in pool])
    assert [m.value for m in got] == [m.value for m in want]
    for rng in ("", "2,4", "4", "a,b", " 1,16 "):
        monkeypatch.setenv("CUDECOMP_TPU_AUTOTUNE_P_ROW_RANGE", rng)
        assert tenv.int_range("CUDECOMP_TPU_AUTOTUNE_P_ROW_RANGE") == \
            jenv.int_range("CUDECOMP_TPU_AUTOTUNE_P_ROW_RANGE")


def _results(ac, halo):
    """The same autotune result in both packages (trials included, one of
    them skipped)."""
    jcfg = cd.GridConfig(gdims=(16, 12, 8), pdims=(2, 2),
                         transpose_axis_contiguous=(ac,) * 3,
                         transpose_method=cd.TransposeMethod.RING_XOR)
    jgrid = cd.make_grid(jcfg, devices=jax.devices()[:4])
    tgrid = types.SimpleNamespace(config=ct.GridConfig.from_dict(
        dataclasses.asdict(jcfg)))
    out = []
    for pkg, at, grid in ((cd, jat, jgrid), (ct, tat, tgrid)):
        trials = [at.TrialRecord((2, 2), "ring_xor", (0.5, 0.25), 0.375,
                                 0.25),
                  at.TrialRecord((1, 4), "ring", (), float("inf"),
                                 float("inf"), skipped=True)]
        hm = pkg.HaloMethod.PALLAS if halo else None
        out.append(at.AutotuneResult(
            grid=grid, best_pdims=(2, 2),
            best_method=pkg.TransposeMethod.RING_XOR, best_time_s=0.375,
            trials=trials, halo_trials=trials[:1] if halo else [],
            best_halo_method=hm))
    return out


@pytest.mark.parametrize("ac,halo", [(False, False), (True, True)])
def test_saved_config_loads_across_packages(tmp_path, ac, halo):
    import json
    jres, tres = _results(ac, halo)
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    jres.save_json(jpath)
    tres.save_json(tpath)
    jbase = cd.GridConfig(gdims=(16, 12, 8))
    tbase = ct.GridConfig(gdims=(16, 12, 8))

    def plain(cfg):
        return {k: getattr(v, "value", v)
                for k, v in dataclasses.asdict(cfg).items()}

    want = plain(jat.load_tuned_config(jpath, jbase))
    assert plain(tat.load_tuned_config(jpath, tbase)) == want
    assert plain(jat.load_tuned_config(tpath, jbase)) == want
    assert plain(tat.load_tuned_config(tpath, tbase)) == want
    assert want["pdims"] == (2, 2) and want["transpose_method"] == "ring_xor"
    j, t = json.load(open(jpath)), json.load(open(tpath))
    for trial in t["trials"] + t["halo_trials"]:
        assert trial.pop("error") is None
    assert t == j  # strict JSON alike: a skipped trial's times are null
    assert "SKIPPED" in tres.report() and "selected" in tres.report()


def test_autotune_protocol_on_four_gloo_ranks(tmp_path):
    run_ranks(protocol_worker, 4, (4, str(tmp_path / "pg"), ["autotune"]),
              300, "the autotuner's 4-rank run")


def test_one_rank_sweeps_every_method_and_layout():
    # one rank on the CPU: every method runs (no exchange), both layouts
    res = ct.autotune(ct.GridConfig(gdims=(16, 12, 8)), "cpu",
                      ct.AutotuneOptions(n_warmup=1, n_trials=2,
                                         autotune_layouts=True,
                                         autotune_halo_method=True,
                                         halo_extents=(1, 1, 1)))
    assert [t.method for t in res.trials] == [
        f"{m}/ac={a}" for m in ("all_to_all", "ring", "ring_xor",
                                "ring_pipelined") for a in (0, 1)]
    assert not any(t.skipped for t in res.trials)
    assert [t.method for t in res.halo_trials] == ["ppermute"]
    assert res.grid.config.pdims == (1, 1) and res.grid.device.type == "cpu"
    assert res.grid.config.halo_method == res.best_halo_method
