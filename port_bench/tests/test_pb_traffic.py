"""The traffic generator: exact cycle counts and the mixes' instruction
shares, counted by the reference interpreter."""

import pytest

from port_bench import traffic
from port_bench.reference import interp
from port_bench.traffic import loops

SEEDS = (0, 17, 2**31 + 9)


@pytest.mark.parametrize("walk", [None, loops.Walk(1, 8, (64, 160), 3, 0),
                                  loops.Walk(2, 4, (40, 96), 4, 2)])
@pytest.mark.parametrize("cycles,units", [(2**12 - 1, 2), (5000, 3), (2**14 - 1, 4)])
def test_every_job_runs_the_mix_cycles(walk, cycles, units):
    mix = loops.Mix("t", cycles, units, (3, 60), walk)
    for seed in SEEDS:
        for j in range(-1, 5):
            assert interp.run(mix.source, mix.job(seed, j)).cycles == cycles


@pytest.mark.parametrize("name", ["loop_2p22", "memstress_2p22"])
def test_every_seed_makes_its_jobs(name):
    mix = traffic.load(name)
    for seed in SEEDS + (11, 13, 2147483659, 3000000001):
        for j in range(-1, 40):
            mix.job(seed, j)


def test_jobs_follow_the_seed():
    mix = traffic.load("memstress_2p22")
    assert mix.job(5, 3) == mix.job(5, 3)
    assert mix.job(5, 3) != mix.job(6, 3)
    assert mix.job(5, 3) != mix.job(5, 4)


def test_every_seed_proves_the_same_sizes():
    mix = traffic.load("memstress_2p22")
    k = mix.walk.sizes

    def painted(seed):  # group bytes before the 0 that ends the painting
        return sorted(mix.job(seed, j).index(0, 1) - 1 for j in range(k))

    assert len(set(painted(SEEDS[0]))) == k
    for seed in SEEDS:
        assert painted(seed) == painted(SEEDS[0])


def test_loop_mix_shares():
    mix = traffic.load("loop_2p22")
    for j in (0, 1):
        r = interp.run(mix.source, mix.job(2**31 + 1, j))
        assert 15 * 2**22 // 16 <= r.cycles <= 2**22 - 1
        assert 0.45 <= r.counts[3] / r.cycles <= 0.55  # '-'
        assert 0.45 <= r.jumps / r.cycles <= 0.55
        assert r.steps / r.cycles < 0.01
        assert r.jumps <= 2**21 and r.alu <= 2**21  # Jump and AddSub at 2^21 rows


def test_memstress_mix_shares():
    mix = traffic.load("memstress_2p22")
    for j in (0, 3):
        r = interp.run(mix.source, mix.job(2**31 + 1, j))
        assert 15 * 2**22 // 16 <= r.cycles <= 2**22 - 1
        assert r.steps / r.cycles >= 0.40
        assert r.jumps / r.cycles >= 0.20
        assert 2**18 <= r.touched <= 2**20
        assert r.steps > 2**20  # MemoryInstrs at 2^21 rows or more
        assert 2**18 < (r.touched + 1) // 2 <= 2**19  # Memory at 2^19 rows
