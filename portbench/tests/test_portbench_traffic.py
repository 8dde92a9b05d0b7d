"""The benchmark's frozen traffic generator equals the program's today, so
that a later change to the program cannot move the benchmark's inputs
unnoticed; and the mixes and search seeds are what the harness needs."""

import numpy as np
import pytest
from repro_torch.core import traffic as program_traffic
from repro_torch.core.problem import spec_16, spec_36, spec_64, spec_tiny

from portbench import traffic

SPECS = (spec_tiny, spec_16, spec_36, spec_64)


@pytest.mark.parametrize("make", SPECS)
def test_application_matrices_equal_the_program(make):
    spec = make()
    assert traffic.APPLICATIONS == program_traffic.APPLICATIONS
    for app in traffic.APPLICATIONS:
        np.testing.assert_array_equal(
            traffic.traffic_matrix(spec, app),
            program_traffic.traffic_matrix(spec, app))


@pytest.mark.parametrize("make", SPECS)
def test_avg_traffic_equals_the_program(make):
    spec = make()
    apps = [a for a in traffic.APPLICATIONS if a != "BFS"]
    np.testing.assert_array_equal(traffic.avg_traffic(spec, apps),
                                  program_traffic.avg_traffic(spec, apps))


@pytest.mark.parametrize("name", ["stage-bfs", "nsga2-bfs",
                                  "stage-batch-avg"])
def test_mixes_load_and_make_their_matrix(name):
    mix = traffic.load_mix(name)
    spec = spec_36()
    f = traffic.matrix(spec, mix)
    assert f.shape == (36, 36) and (f >= 0).all() and f.sum() > 0
    if len(mix["apps"]) == 1:
        np.testing.assert_array_equal(
            f, program_traffic.traffic_matrix(spec, mix["apps"][0]))


def test_a_mix_missing_a_key_or_naming_an_unknown_app_is_refused(tmp_path):
    (tmp_path / "a.json").write_text('{"optimizer": "stage", "apps": ["BFS"]}')
    with pytest.raises(ValueError, match="lacks"):
        traffic.load_mix("a", tmp_path)
    (tmp_path / "b.json").write_text(
        '{"optimizer": "stage", "apps": ["XYZ"], "max_evals": 10, '
        '"max_call": 1, "pool": 1, "config": {}}')
    with pytest.raises(ValueError, match="unknown"):
        traffic.load_mix("b", tmp_path)
    with pytest.raises(FileNotFoundError):
        traffic.load_mix("c", tmp_path)


def test_pools_are_fixed_and_orders_are_drawn_from_the_run_seed():
    mix = traffic.load_mix("stage-bfs")
    assert traffic.pool(mix) == traffic.pool(dict(mix))
    assert len(set(traffic.pool(mix))) == mix["pool"]
    for seed in (0, 2 ** 31 + 3, 3 * 10 ** 12):
        o = traffic.order(seed, 2, 16)
        assert sorted(o) == list(range(16))
        np.testing.assert_array_equal(o, traffic.order(seed, 2, 16))
    assert not np.array_equal(traffic.order(1, 0, 16),
                              traffic.order(2, 0, 16))


def test_search_seeds_are_fixed_by_the_run_seed_and_fit_31_bits():
    for seed in (0, 1, 2 ** 31 + 7, 2 ** 40, 3 * 10 ** 12):
        seeds = [traffic.search_seed(seed, i) for i in range(50)]
        assert seeds == [traffic.search_seed(seed, i) for i in range(50)]
        assert len(set(seeds)) == 50
        assert all(0 <= s < 2 ** 31 for s in seeds)
    assert traffic.search_seed(1, 1) != traffic.search_seed(2, 1)
