"""The traffic generator: the same seed gives the same batches, another seed
the same work in another order, and the parameters are the mix file's."""
import collections
import math

import pytest
import torch

from edgebench import workload

MIXES = ("split-w8", "split-f32", "split-mix")


def _key(b):
    return (b.round, b.B, b.S, b.version, b.k)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_batches(name):
    mix = workload.load_mix(name)
    a = workload.schedule(mix, 2 ** 31 + 12345, 4, 1000, "cpu", n_rounds=3)
    b = workload.schedule(mix, 2 ** 31 + 12345, 4, 1000, "cpu", n_rounds=3)
    assert [_key(x) for x in a] == [_key(x) for x in b]
    assert all(torch.equal(x.tokens, y.tokens) for x, y in zip(a, b))


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_same_work_other_order(name):
    mix = workload.load_mix(name)
    a = workload.schedule(mix, 7, 4, 1000, "cpu", n_rounds=3)
    b = workload.schedule(mix, 8, 4, 1000, "cpu", n_rounds=3)
    for r in range(3):
        ra = [_key(x) for x in a if x.round == r]
        rb = [_key(x) for x in b if x.round == r]
        assert sorted(ra) == sorted(rb) and ra != rb
    assert not torch.equal(a[0].tokens.flatten()[:16], b[0].tokens.flatten()[:16])


@pytest.mark.parametrize("name", MIXES)
def test_parameters_are_the_files(name):
    mix = workload.load_mix(name)
    plan = workload.round_plan(mix, 4)
    M = mix["round"]
    assert len(plan) == M
    sizes = range(mix["batch"]["min"], mix["batch"]["max"] + 1)
    assert collections.Counter(p[0] for p in plan) == {b: M // len(sizes) for b in sizes}
    share = sum(mix["versions"].values())
    assert collections.Counter(p[2] for p in plan) == {
        v: M * w // share for v, w in mix["versions"].items()}
    assert collections.Counter(p[3] for p in plan) == {k: M // 4 for k in range(4)}
    S = sorted(p[1] for p in plan)
    assert len(set(S)) == M and sum(p["batches"] for p in mix["seq"]["pieces"]) == M
    # each piece: evenly spaced in log S, the quantiles of its log-uniform range
    at = 0
    for piece in mix["seq"]["pieces"]:
        lo, hi, k = piece["min"], piece["max"], piece["batches"]
        for i, s in enumerate(S[at:at + k]):
            assert lo <= s <= hi
            assert abs(math.log(s / lo) / math.log(hi / lo) - (i + 0.5) / k) < 0.01
        at += k


@pytest.mark.parametrize("name", MIXES)
def test_the_tail_is_longer_and_thinner_than_the_body(name):
    body, tail = workload.load_mix(name)["seq"]["pieces"]
    assert tail["min"] >= body["max"] and tail["batches"] < body["batches"]
    density = [p["batches"] / math.log(p["max"] / p["min"]) for p in (body, tail)]
    assert density[1] < density[0]


def test_pieces_that_do_not_fill_the_round_are_refused():
    mix = workload.load_mix("split-w8")
    with pytest.raises(ValueError, match="lengths for a round"):
        workload.seq_lengths(mix, mix["round"] + 1)


def test_tokens_shapes_and_range():
    mix = workload.load_mix("split-w8")
    batches = workload.schedule(mix, 5, 4, 321, "cpu", n_rounds=2)
    for b in batches:
        assert tuple(b.tokens.shape) == (b.B, b.S) and b.tokens.dtype == torch.int64
        assert int(b.tokens.min()) >= 0 and int(b.tokens.max()) < 321


def test_check_sample_holds_the_longest_of_each_version():
    mix = workload.load_mix("split-mix")
    batches = workload.schedule(mix, 99, 4, 100, "cpu", n_rounds=2)
    keep = workload.check_sample(batches, 99, 8)
    assert len(keep) == 8 and all(batches[i].round == 0 for i in keep)
    for v in mix["versions"]:
        longest = max(b.S for b in batches if b.round == 0 and b.version == v)
        assert any(batches[i].version == v and batches[i].S == longest for i in keep)
    assert all(0 <= row < batches[i].B for i, row in keep.items())
    assert keep == workload.check_sample(batches, 99, 8)
