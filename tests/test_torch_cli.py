"""The port's user entry points on the CPU: checkpoint files read both ways
with the JAX package, bench_prep's per-seed prep against the JAX
package's, the CLI's commands at small sizes and its figures (``run
dist``: tests/test_torch_dist.py).

Tolerances: checkpoints exact (the same arrays, types and key names);
bench_prep in float32 against JAX's jitted prep of the same seed (the
JAX package's bench_prep, with the grid's origin in float32 as it is
without 64-bit types): dp_ok and the corridor and lane masks identical;
goals' x, y, theta and delta within 2e-5 absolute (a few float32 ulps at
100 m), v within 1e-3 and a within 1e-2 (the DP's profile divides
position differences by dt = 0.1 once and twice: one ulp of 100 m is
7.6e-5 m/s and 7.6e-4 m/s^2 there); planes and segments within 1e-3
scaled by 1 + |value| (the lane arrays stay float64 on the JAX side with
64-bit types on, float32 in the port, as in the fixture).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilqr_tpu import checkpoint as JCk
from cilqr_tpu import corridor as JCor
from cilqr_tpu import costs as JCo
from cilqr_tpu import dp as JD
from cilqr_tpu import pipeline as JP
from cilqr_tpu import scenario as JS
from cilqr_tpu import types as JT
from cilqr_tpu import world as JW
from cilqr_tpu.config import PlannerConfig as JPlannerConfig
from cilqr_tpu_torch import bench_prep as TBp
from cilqr_tpu_torch import checkpoint as TCk
from cilqr_tpu_torch import profiling as TPr
from cilqr_tpu_torch import run as TRun
from cilqr_tpu_torch import scenario as TS
from cilqr_tpu_torch.config import PlannerConfig
from cilqr_tpu_torch.costs import ConstraintSet
from cilqr_tpu_torch.types import CostBreakdown, SolveResult


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _same_file(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def _result(rng, clipped):
    """A SolveResult of random values of the solver's shapes and types,
    as numpy arrays by field."""
    f = {"xs": rng.normal(size=(3, 81, 6)), "us": rng.normal(size=(3, 80, 2)),
         "status": rng.integers(0, 6, 3).astype(np.int32),
         "iters": rng.integers(0, 50, 3).astype(np.int32),
         "lam": rng.uniform(size=3), "init_xs": rng.normal(size=(3, 81, 6)),
         "init_us": rng.normal(size=(3, 80, 2))}
    f = {k: v.astype(np.float32) if v.dtype == np.float64 else v
         for k, v in f.items()}
    cost = {k: rng.normal(size=3).astype(np.float32)
            for k in ("total", "target", "dynamic", "corridor", "lane")}
    return f, cost, (rng.uniform(size=3) < 0.5) if clipped else None


@pytest.mark.parametrize("clipped", [True, False])
def test_checkpoints_read_both_ways(tmp_path, clipped):
    jscn = JS.make_scenario(4)                                 # float32
    tscn = TS.make_scenario(4, dtype=torch.float32, device="cpu")
    JCk.save_scenario(tmp_path / "j_scn.npz", jscn)
    TCk.save_scenario(tmp_path / "t_scn.npz", tscn)
    _same_file(tmp_path / "j_scn.npz", tmp_path / "t_scn.npz")
    got = TCk.load_scenario(tmp_path / "j_scn.npz", device="cpu")
    back = JCk.load_scenario(tmp_path / "t_scn.npz")
    for k in TCk.SCENARIO_KEYS:
        want = np.asarray(TCk._leaf(jscn, k))
        assert _np(TCk._leaf(got, k)).dtype == want.dtype, k
        np.testing.assert_array_equal(_np(TCk._leaf(got, k)), want)
        np.testing.assert_array_equal(np.asarray(TCk._leaf(back, k)), want)

    f, cost, lc = _result(np.random.default_rng(0), clipped)
    jres = JT.SolveResult(
        **{k: jnp.asarray(v) for k, v in f.items()},
        cost=JT.CostBreakdown(**{k: jnp.asarray(v) for k, v in cost.items()}),
        lane_clipped=None if lc is None else jnp.asarray(lc))
    tres = SolveResult(
        **{k: torch.as_tensor(v) for k, v in f.items()},
        cost=CostBreakdown(**{k: torch.as_tensor(v)
                              for k, v in cost.items()}),
        lane_clipped=None if lc is None else torch.as_tensor(lc))
    JCk.save_result(tmp_path / "j_res.npz", jres)
    TCk.save_result(tmp_path / "t_res.npz", tres)
    _same_file(tmp_path / "j_res.npz", tmp_path / "t_res.npz")
    got = TCk.load_result(tmp_path / "j_res.npz", device="cpu")
    back = JCk.load_result(tmp_path / "t_res.npz")
    for k in TCk.RESULT_KEYS:
        want = TCk._leaf(jres, k)
        if want is None:
            assert TCk._leaf(got, k) is None and TCk._leaf(back, k) is None
            continue
        np.testing.assert_array_equal(_np(TCk._leaf(got, k)),
                                      np.asarray(want), err_msg=k)
        assert _np(TCk._leaf(got, k)).dtype == np.asarray(want).dtype, k
        np.testing.assert_array_equal(np.asarray(TCk._leaf(back, k)),
                                      np.asarray(want), err_msg=k)


def test_bench_prep_matches_jax_prep():
    """Seeds 0 and 1 in float32: the port's batched prep against the JAX
    package's bench_prep prep_one (its steps, jitted, one seed a call)."""
    seeds = (0, 1)
    cfg, jcfg = PlannerConfig(), JPlannerConfig()
    scns = TS.make_scenario_batch(seeds, dtype=torch.float32, device="cpu")
    goals, cons, ok = TBp.prep(scns, cfg)

    cl = JS.make_centerline()
    barriers = JS.build_road_barriers(cl)
    jgrid = JW.build_barrier_grid(barriers[0], jcfg.dp.grid_cell,
                                  half=jcfg.vehicle.radius)
    jgrid = jgrid._replace(origin=jgrid.origin.astype(jnp.float32))
    jlane = JP.make_lane_tuple(barriers[1], barriers[2], jcfg)

    @jax.jit
    def prep_one(scn):
        dp_res = JD.plan(scn, *map(jnp.asarray, TBp.START[:3]), jcfg, jgrid)
        cors = JCor.plan_corridors(scn, dp_res.traj, jcfg.corridor, jlane)
        c = JCo.shrink_and_normalize(
            cors.planes, cors.plane_mask, cors.left_planes, cors.left_segs,
            cors.left_mask, cors.right_planes, cors.right_segs,
            cors.right_mask, jcfg.ilqr, jcfg.vehicle)
        return JP.coarse_to_states(dp_res.traj), c, dp_res.ok

    for b, seed in enumerate(seeds):
        jg, jc, jok = prep_one(JS.make_scenario(seed, cl=cl, barriers=barriers,
                                                dtype=jnp.float32))
        assert bool(ok[b]) == bool(jok)
        err = np.abs(_np(goals[b]) - np.asarray(jg)).max(axis=0)
        assert (err[[0, 1, 2, 5]] <= 2e-5).all(), err      # x, y, theta, delta
        assert err[3] <= 1e-3 and err[4] <= 1e-2, err       # v, a
        for name, t, j in zip(ConstraintSet._fields, cons, jc):
            t, j = _np(t[b]), np.asarray(j)
            if t.dtype == np.bool_:
                np.testing.assert_array_equal(t, j, err_msg=name)
            else:
                assert (np.abs(t - j) / (1 + np.abs(j))).max() <= 1e-3, name


def test_bench_prep_writes_the_fixture_layout(tmp_path, capsys):
    out = tmp_path / "p.npz"
    assert TBp.main(["--batch", "2", "--cpu", "--out", str(out)]) == 0
    with np.load(out) as got, np.load(TBp.os.path.join(
            TBp.os.path.dirname(TBp.os.path.dirname(TBp.__file__)),
            "benchdata", "problems.npz")) as ref:
        assert sorted(got.files) == sorted(ref.files)
        for k in got.files:
            assert got[k].dtype == ref[k].dtype, k
            assert got[k].shape[1:] == ref[k].shape[1:], k
            assert got[k].shape[0] == 2
    assert "wrote" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        TBp.main(["--batch", "2"])          # --out is required


def test_cli_plan_save_and_figures(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    res = tmp_path / "plan.npz"
    png = tmp_path / "plan.png"
    gif = tmp_path / "plan.gif"
    assert TRun.main(["plan", "--cpu", "--seed", "2", "--save", str(res),
                      "--out", str(png), "--animate", str(gif),
                      "--animate-every", "40"]) == 0
    line = capsys.readouterr().out
    assert "dp_ok=True" in line and "status=" in line, line
    r = TCk.load_result(res, device="cpu")
    assert r.xs.shape == (81, 6) and r.xs.dtype == torch.float32
    assert torch.isfinite(r.xs).all()
    for p in (png, tmp_path / "plan_states.png", gif):
        assert p.stat().st_size > 1000, p


def test_cli_scenario_batch_mpc(tmp_path, capsys):
    out = tmp_path / "scn.npz"
    assert TRun.main(["scenario", "--cpu", "--seed", "3", "--f64", "--out",
                      str(out)]) == 0
    got = TCk.load_scenario(out, dtype=torch.float64, device="cpu")
    want = TS.make_scenario(3, dtype=torch.float64, device="cpu")
    assert torch.equal(got.dyn_obs, want.dyn_obs)
    assert torch.equal(got.centerline.x, want.centerline.x)

    cfg = tmp_path / "grid.json"
    cfg.write_text(json.dumps({"dp": {"collision_mode": "grid"}}))
    assert TRun.main(["batch", "--cpu", "--batch", "2", "--config",
                      str(cfg)]) == 0
    assert TRun.main(["mpc", "--cpu", "--cycles", "1", "--seed", "1"]) == 0
    lines = capsys.readouterr().out
    assert "batch=2" in lines and "statuses:" in lines
    assert "mpc cycles=1" in lines and "corridor_ok=2/2" in lines, lines


def test_profiling_on_the_cpu():
    """span, timed and trace with the CPU as their device (nothing to
    synchronise there): a span is a no-op while the tracer is off and,
    inside tracing(), a profiler range that trace records beside the
    host's operations, with its host time; trace records the operations."""
    x = torch.ones(64, 64)
    with TPr.span("solve"):
        x @ x
    best, out = TPr.timed(lambda a: a @ a, x, reps=2, device="cpu")
    assert best > 0 and torch.equal(out, x @ x)
    with TPr.tracing(), TPr.trace(cuda=False) as prof:
        with TPr.span("solve"):
            x @ x
    assert any("mm" in e.key for e in prof.key_averages())
    assert any(e.key == "solve" for e in prof.key_averages())
    st = TPr.collect().spans["solve"]
    assert st.count == 1 and st.inclusive_s > 0 and st.device_s is None
