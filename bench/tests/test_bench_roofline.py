"""The roofline counts against hand counts at small shapes."""

import json

import numpy as np
import pytest

import bench_tiny  # noqa: F401  (puts the checkout on the path)
from bench.roofline import greedy_map, partial_trace, phase2_select, requests


def test_phase2_select_by_hand():
    # N1 = 2, Nr = 3 (N = 6), k_max = 4, rows of 2 and 0 picks.
    # row of s = 2: norms 2·6·2 = 24; steps t = 0, 1: 2·6 + 8·2·t = 12, 28;
    # one downdate 2·6·2 + 3·6 = 42; row of 0: nothing.
    flops, nbytes = phase2_select.work(2, 3, 4, [2, 0])
    assert flops == 24 + 12 + 28 + 42
    # a row: 4 uniforms, its size, (2 + 3)·4 factor words, 4 picks
    assert nbytes == 4 * 2 * (4 + 1 + 20 + 4)


def test_greedy_map_by_hand():
    # N = 5, k = 3, all live: scores 2·5·3 = 30; live steps t = 0, 1, 2:
    # 2·5·t + 4·5 = 20, 30, 40
    assert greedy_map.work(5, 3, 3) == (30 + 20 + 30 + 40,
                                        4 * (5 + 3 * 5) + 4 * 3)
    # a dead step only scores
    assert greedy_map.work(5, 3, 1)[0] == 30 + 20


def test_partial_trace_by_hand():
    assert partial_trace.work(2, 3) == (2 * 36, 4 * (36 + 4 + 9))


def test_request_counts_by_hand():
    # P = 2 positions, d = 3, f = 4, keep 2, both steps live
    f = requests.ffn_prune(2, 3, 4, 2, 2)
    assert f == 4 * 2 * 3 + 4 * 2 * 3 * 4 + 5 * 2 * 4 + 3 * 2 * 4 \
        + 2 * 2 * 4 * 4 + greedy_map.work(4, 2, 2)[0]
    # N1 = N2 = 2, subsets of 1 and 2 items
    # two Θ builds, A once and C once, the two halves' updates
    assert requests.krk_sweep(2, 2, [1, 2]) == \
        2 * ((1 + 1) + (4 + 8) + 16) + 2 * 2 * 16 + 2 * 9 * (8 + 8)
    assert requests.krk_log_likelihood(2, 2, [3]) == pytest.approx(
        9 + 9 * 16)


def test_counts_of_records_by_hand():
    """Each kernel's count reads only the records that need its work: a
    draw's picks, a MAP's matrix size and picks, a learning call's
    sweeps (one A and one C each)."""
    draw = {"units": 1, "factor_sizes": (2, 3),
            "picks": np.array([[4, 1, -1, -1], [-1, -1, -1, -1]])}
    pick = {"units": 1, "map_size": 5, "picks": np.array([3, 0, -1])}
    learn = {"units": 3, "sweeps": 3, "factor_sizes": (2, 3)}
    assert phase2_select.of_record(draw) == [phase2_select.work(
        2, 3, 4, [2, 0])]
    assert greedy_map.of_record(pick) == [greedy_map.work(5, 3, 2)]
    assert partial_trace.of_record(learn) == [partial_trace.work(2, 3)] * 6
    for mod, own in ((phase2_select, draw), (greedy_map, pick),
                     (partial_trace, learn)):
        for rec in (draw, pick, learn):
            if rec is not own:
                assert mod.of_record(rec) == []


def test_peaks_table():
    with open(bench_tiny.ROOT / "bench" / "roofline" / "peaks.json") as f:
        peaks = json.load(f)
    assert peaks["flops"]["fp32"] == 67e12
    assert peaks["hbm_bytes_per_s"] == 3.35e12
