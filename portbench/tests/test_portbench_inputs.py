"""The traffic generator: the same seed gives the same inputs."""

import json

import numpy as np

from portbench import inputs, registry

CONFIG = registry.load_json(registry.HERE / "configs" / "pedtest_spec.json")
BIG = 2**31 + 12345


def test_same_seed_same_arrays():
    a = inputs.scenario_arrays(CONFIG, BIG, 3)
    b = inputs.scenario_arrays(CONFIG, BIG, 3)
    c = inputs.scenario_arrays(CONFIG, BIG + 1, 3)
    for k in a:
        if k == "centerline":
            continue
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["static_obs"], c["static_obs"])
    assert a["dyn_obs"].shape[:2] == (3, 9)


def test_scenario_seeds_and_perturbations():
    assert inputs.scenario_seeds(7, 4) == [28, 29, 30, 31]
    p = inputs.perturbations(BIG, 5, 16, 0.2)
    np.testing.assert_array_equal(p, inputs.perturbations(BIG, 5, 16, 0.2))
    assert p.shape == (5, 16) and np.abs(p).max() <= 0.2
    assert not np.array_equal(p[0], p[1])
    s = inputs.starts(CONFIG, p[0])
    np.testing.assert_array_equal(s[:, [0, 2, 3]],
                                  np.tile([0.0, 0.0, 10.0], (16, 1)))
    np.testing.assert_array_equal(s[:, 1], p[0])


def test_samples_from_the_seed():
    lanes = inputs.sample_lanes(BIG, 1024, 256)
    assert len(set(lanes.tolist())) == 256 and list(lanes) == sorted(lanes)
    np.testing.assert_array_equal(lanes, inputs.sample_lanes(BIG, 1024, 256))
    assert 0 <= inputs.sample_index(BIG, 16) < 16
    assert len(inputs.sample_lanes(1, 4, 256)) == 4


def test_negative_seed_is_a_seed():
    a = inputs.scenario_arrays(CONFIG, -3, 1)
    b = inputs.scenario_arrays(CONFIG, -3, 1)
    np.testing.assert_array_equal(a["dyn_obs"], b["dyn_obs"])
    json.dumps(inputs.scenario_seeds(-3, 1))


def test_fixed_scenarios_are_one_set_in_a_seeded_order():
    a = inputs.scenario_seeds(BIG, 64, fixed=True)
    b = inputs.scenario_seeds(BIG + 1, 64, fixed=True)
    assert sorted(a) == sorted(b) == list(range(64)) and a != b
    assert a == inputs.scenario_seeds(BIG, 64, fixed=True)
    pa = inputs.perturbations(BIG, 3, 64, 0.2, fixed=True)
    pb = inputs.perturbations(BIG + 1, 3, 64, 0.2, fixed=True)
    p0 = inputs.perturbations(0, 3, 64, 0.2)
    np.testing.assert_array_equal(pa[:, np.argsort(a)], p0)
    np.testing.assert_array_equal(pb[:, np.argsort(b)], p0)
